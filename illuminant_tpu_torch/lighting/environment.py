"""Scene environment: uniforms and light-source containers.

Counterpart of illuminant_tpu/lighting/environment.py. The host side
mirrors LightingEnvironment (LightingEnvironment.cs:13-49): a mutable
container of lights, obstructions, height volumes and billboards, whose
obstructions carry the dirty flags the renderer's auto-invalidation
consumes. The device side packs the lights into fixed-capacity SoA tensors
(one batched axis instead of the reference's 128-instance draws,
LightingRenderer.cs:1149-1166).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.pytree import tensor_dataclass
from ..ops import sdf_primitives
from ..sdf.volume import SdfObstructions

RAMP_LINEAR = 0
RAMP_EXPONENTIAL = 1
RAMP_NONE = 2


@tensor_dataclass
class EnvironmentUniforms:
    """Uniforms.Environment (Uniforms.cs:15-77): 0-d float32 tensors and
    the (4,) premultiplied ambient color."""

    ground_z: torch.Tensor
    maximum_z: torch.Tensor
    z_to_y_multiplier: torch.Tensor
    light_occlusion: torch.Tensor
    ambient: torch.Tensor

    @staticmethod
    def make(ground_z=0.0, maximum_z=128.0, z_to_y=0.0, light_occlusion=0.0,
             ambient=(0.0, 0.0, 0.0, 1.0),
             device="cuda") -> "EnvironmentUniforms":
        def f32(v):
            return torch.tensor(v, dtype=torch.float32, device=device)

        return EnvironmentUniforms(
            ground_z=f32(ground_z), maximum_z=f32(maximum_z),
            z_to_y_multiplier=f32(z_to_y),
            light_occlusion=f32(light_occlusion), ambient=f32(ambient))


@tensor_dataclass
class SphereLights:
    """SoA sphere lights (LightSource.cs:214-311) padded to a capacity;
    `active` masks the pads. position (L, 3); color (L, 4) with opacity
    folded into alpha; properties = (radius, ramp_length, ramp_mode,
    cast_shadows); more = (ao_radius, distance_falloff, y_falloff_factor,
    ao_opacity); specular_color_power (L, 4); active (L,) 0/1.
    `ramp_texture` (L, RH, RW, 3) and `ramp_offset_rate` (L, 3) = (offset,
    rate, has-ramp flag) feed the WithRamp epilogue (SphereLightCore.fxh:
    99-119); both are None when no light has a ramp texture."""

    position: torch.Tensor
    color: torch.Tensor
    properties: torch.Tensor
    more: torch.Tensor
    specular_color_power: torch.Tensor
    active: torch.Tensor
    ramp_texture: Optional[torch.Tensor] = None
    ramp_offset_rate: Optional[torch.Tensor] = None

    @property
    def capacity(self) -> int:
        return self.position.shape[0]

    @staticmethod
    def empty(capacity: int, device="cuda") -> "SphereLights":
        """`capacity` inactive lanes."""
        return pack_sphere_lights([], capacity=capacity, device=device)


@dataclasses.dataclass
class SphereLightSource:
    """Host-side sphere light (LightSource.cs:214-311)."""

    position: tuple = (0.0, 0.0, 0.0)
    radius: float = 0.0
    ramp_length: float = 1.0
    ramp_mode: int = RAMP_LINEAR
    color: tuple = (1.0, 1.0, 1.0, 1.0)
    opacity: float = 1.0
    cast_shadows: bool = True
    ambient_occlusion_radius: float = 0.0
    ambient_occlusion_opacity: float = 1.0
    falloff_y_factor: float = 1.0
    shadow_distance_falloff: Optional[float] = None
    specular_color: tuple = (0.0, 0.0, 0.0)
    specular_power: float = 2.0
    # Ramp texture (LightSource.cs TextureRef, offset / rate :58-103):
    # an (RH, RW, 3) array; RH = 1 is the 1D distance ramp.
    ramp_texture: Optional[object] = None
    ramp_offset: float = 0.0
    ramp_rate: float = 1.0
    # LightSource.BlendMode (LightSource.cs:65): "additive", "subtractive"
    # (darkness lights) or "max"; the renderer batches lights by it.
    blend_mode: str = "additive"


def pack_sphere_lights(lights: List[SphereLightSource],
                       capacity: Optional[int] = None,
                       device="cuda") -> SphereLights:
    """Pack host lights into the SoA tensors (the LightVertex build,
    LightingRenderer.cs:1193-1446, minus instancing)."""
    n = len(lights)
    cap = capacity or max(n, 1)
    out_pos = np.zeros((cap, 3), np.float32)
    out_col = np.zeros((cap, 4), np.float32)
    out_props = np.zeros((cap, 4), np.float32)
    out_more = np.zeros((cap, 4), np.float32)
    out_more[:, 2] = 1.0
    out_more[:, 3] = 1.0
    out_spec = np.zeros((cap, 4), np.float32)
    out_active = np.zeros((cap,), np.float32)
    ramps = [np.asarray(l.ramp_texture) for l in lights
             if l.ramp_texture is not None]
    out_ramp = out_ramp_or = None
    if ramps:
        rh = max(r.shape[0] for r in ramps)
        rw = max(r.shape[1] for r in ramps)
        out_ramp = np.ones((cap, rh, rw, 3), np.float32)
        out_ramp_or = np.tile(np.asarray([0.0, 1.0, 0.0], np.float32),
                              (cap, 1))
    for i, l in enumerate(lights):
        out_pos[i] = l.position
        col = np.asarray(l.color, np.float32).copy()
        col[3] *= l.opacity
        out_col[i] = col
        out_props[i] = [l.radius, l.ramp_length, float(l.ramp_mode),
                        1.0 if l.cast_shadows else 0.0]
        out_more[i] = [l.ambient_occlusion_radius,
                       l.shadow_distance_falloff or 0.0,
                       max(l.falloff_y_factor, 1e-3),
                       l.ambient_occlusion_opacity]
        out_spec[i, :3] = l.specular_color
        out_spec[i, 3] = l.specular_power
        out_active[i] = 1.0
        if out_ramp is not None and l.ramp_texture is not None:
            tex = np.asarray(l.ramp_texture, np.float32)[..., :3]
            out_ramp[i, :tex.shape[0], :tex.shape[1]] = tex
            out_ramp_or[i] = [l.ramp_offset, l.ramp_rate, 1.0]

    def t(a):
        return None if a is None else torch.as_tensor(a, device=device)

    return SphereLights(position=t(out_pos), color=t(out_col),
                        properties=t(out_props), more=t(out_more),
                        specular_color_power=t(out_spec),
                        active=t(out_active), ramp_texture=t(out_ramp),
                        ramp_offset_rate=t(out_ramp_or))


@dataclasses.dataclass
class LightObstruction:
    """Host-side SDF obstruction (LightObstruction.cs:10-148).

    Assigning center / size / rotation / type clears `is_valid`, and
    flipping `is_dynamic` sets `has_dynamicity_changed`: the renderer's
    auto-invalidation consumes both, like the reference's setters
    (LightObstruction.cs:22-120) feeding AutoInvalidateDistanceField
    (LightingRenderer.cs:1977-2015). `serial` is unique in the process."""

    type: int = sdf_primitives.TYPE_BOX
    center: tuple = (0.0, 0.0, 0.0)
    size: tuple = (1.0, 1.0, 1.0)
    rotation: tuple = (0.0, 0.0, 0.0, 1.0)
    is_dynamic: bool = False

    def __setattr__(self, name, value):
        if name in ("center", "size", "rotation", "type") and \
                "center" in self.__dict__:
            object.__setattr__(self, "is_valid", False)
        if name == "is_dynamic" and "is_dynamic" in self.__dict__ and \
                self.__dict__["is_dynamic"] != value:
            object.__setattr__(self, "has_dynamicity_changed", True)
        object.__setattr__(self, name, value)

    _serial_counter = itertools.count()

    def __post_init__(self):
        object.__setattr__(self, "is_valid", False)  # new: needs a raster
        object.__setattr__(self, "has_dynamicity_changed", False)
        # The renderer's add / remove snapshot compares serials: id() is
        # recycled by the allocator, so a remove and an add at one address
        # would compare equal and skip the invalidation.
        object.__setattr__(self, "serial", next(self._serial_counter))

    @staticmethod
    def box(center, size, is_dynamic=False):
        return LightObstruction(sdf_primitives.TYPE_BOX, center, size,
                                is_dynamic=is_dynamic)

    @staticmethod
    def ellipsoid(center, size, is_dynamic=False):
        return LightObstruction(sdf_primitives.TYPE_ELLIPSOID, center, size,
                                is_dynamic=is_dynamic)

    @staticmethod
    def cylinder(center, size, is_dynamic=False):
        return LightObstruction(sdf_primitives.TYPE_CYLINDER, center, size,
                                is_dynamic=is_dynamic)


@dataclasses.dataclass
class LightingEnvironment:
    """Host scene container (LightingEnvironment.cs:13-49)."""

    lights: list = dataclasses.field(default_factory=list)
    obstructions: list = dataclasses.field(default_factory=list)
    height_volumes: list = dataclasses.field(default_factory=list)
    billboards: list = dataclasses.field(default_factory=list)
    ground_z: float = 0.0
    maximum_z: float = 128.0
    z_to_y_multiplier: float = 0.0
    ambient: tuple = (0.0, 0.0, 0.0, 1.0)
    light_occlusion: float = 0.0

    def uniforms(self, device="cuda") -> EnvironmentUniforms:
        return EnvironmentUniforms.make(
            ground_z=self.ground_z, maximum_z=self.maximum_z,
            z_to_y=self.z_to_y_multiplier,
            light_occlusion=self.light_occlusion, ambient=self.ambient,
            device=device)

    def pack_obstructions(self, capacity: Optional[int] = None,
                          dynamic: Optional[bool] = None,
                          device="cuda") -> SdfObstructions:
        """Pack obstructions; dynamic=True/False selects the partition
        (DynamicDistanceField, SDF/DistanceField.cs:248-321)."""
        obs = self.obstructions
        if dynamic is not None:
            obs = [o for o in obs if o.is_dynamic == dynamic]
        return SdfObstructions.from_lists(
            types=[o.type for o in obs], centers=[o.center for o in obs],
            sizes=[o.size for o in obs],
            rotations=[o.rotation for o in obs], capacity=capacity,
            device=device)


@dataclasses.dataclass
class ReplicatedLight:
    """Per-instance overrides (LightSource.cs:615-620)."""

    position: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    radius: Optional[float] = None
    ramp_length: Optional[float] = None
    opacity: Optional[float] = None
    color: Optional[tuple] = None
    specular_color: Optional[tuple] = None
    specular_power: Optional[float] = None


@dataclasses.dataclass
class LightSourceReplicator:
    """Mass instancing of a sphere-light template (LightSource.cs:601-613):
    the replicated set expands into the same batched SphereLights lanes
    the accumulator already takes."""

    template: SphereLightSource = dataclasses.field(
        default_factory=SphereLightSource)
    lights: list = dataclasses.field(default_factory=list)

    def clear(self):
        self.lights.clear()

    def add(self, light: ReplicatedLight):
        self.lights.append(light)

    def expand(self) -> list:
        """-> list of SphereLightSource with the overrides applied."""
        t = self.template

        def pick(value, default):
            return default if value is None else value

        return [dataclasses.replace(
            t, position=r.position, radius=pick(r.radius, t.radius),
            ramp_length=pick(r.ramp_length, t.ramp_length),
            opacity=pick(r.opacity, t.opacity),
            color=t.color if r.color is None else tuple(r.color),
            specular_color=(t.specular_color if r.specular_color is None
                            else tuple(r.specular_color)),
            specular_power=pick(r.specular_power, t.specular_power))
            for r in self.lights]
