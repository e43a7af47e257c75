"""Scene environment: uniforms and light-source containers.

Counterpart of illuminant_tpu/lighting/environment.py for sphere lights and
obstructions. The host side mirrors LightingEnvironment
(LightingEnvironment.cs:13-49); the device side packs the lights into
fixed-capacity SoA tensors (one batched axis instead of the reference's
128-instance draws, LightingRenderer.cs:1149-1166).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

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
    Ramp textures (the WithRamp epilogue) are not ported (ROADMAP M4)."""

    position: torch.Tensor
    color: torch.Tensor
    properties: torch.Tensor
    more: torch.Tensor
    specular_color_power: torch.Tensor
    active: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.position.shape[0]


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

    def t(a):
        return torch.as_tensor(a, device=device)

    return SphereLights(position=t(out_pos), color=t(out_col),
                        properties=t(out_props), more=t(out_more),
                        specular_color_power=t(out_spec),
                        active=t(out_active))


@dataclasses.dataclass
class LightObstruction:
    """Host-side SDF obstruction (LightObstruction.cs:10-148). The JAX
    package's renderer-invalidation bookkeeping is not ported."""

    type: int = sdf_primitives.TYPE_BOX
    center: tuple = (0.0, 0.0, 0.0)
    size: tuple = (1.0, 1.0, 1.0)
    rotation: tuple = (0.0, 0.0, 0.0, 1.0)
    is_dynamic: bool = False

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
