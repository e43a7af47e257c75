"""Particle force and modifier transforms.

Counterpart of illuminant_tpu/particles/transforms.py (Transforms.cs and
its shaders): FMA (FMA.fx), MatrixMultiply (MatrixMultiply.fx) and its
TRS form GeometricTransform, Gravity (Gravity.fx), Noise / SpatialNoise
(Noise.fx), VectorField, and the Sensor analyzer, each restricted by an
optional area (TransformArea, ParticleTransform.cs:35) and a category
filter.

Device functions are pure (position, velocity) -> (position, velocity)
over the whole (N, 4) state. Host classes evaluate their parameters into
uniforms with `uniforms(now, device)`; each value is uploaded once and
again only when it changes (core/upload.py), so a transform whose
parameters hold still costs no host-to-device copy per tick.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.pytree import tensor_dataclass
from ..core.upload import cached_upload
from ..ops import noise as noise_ops
from ..ops import sdf_primitives
from ..ops.coords import mul_point_rows
from .state import SystemUniforms, check_category_filter

MAX_ATTRACTORS = 16  # Gravity.fx:3


def _cps(cycles_per_second) -> float:
    """cycles_per_second None (no time scaling) packs as -1."""
    return -1.0 if cycles_per_second is None else cycles_per_second


def _time_weight(w, cycles_per_second, su: SystemUniforms):
    """t = weight * dt_ms / TimeDivisor with TimeDivisor = 1000 / cps
    (Transforms.cs:40) == weight * dt * cps; cps < 0 leaves the weight."""
    return torch.where(cycles_per_second >= 0.0,
                       w * su.dt * cycles_per_second, w)


# --------------------------------------------------------------------------
# Area weighting (ParticleTransform.cs:294-325, FMA.fx:15-20)


@tensor_dataclass
class AreaUniforms:
    type: torch.Tensor  # () int32; 0 = everywhere
    center: torch.Tensor  # (3,)
    size: torch.Tensor  # (3,)
    falloff: torch.Tensor  # ()
    rotation: torch.Tensor  # (4,) quaternion
    strength: torch.Tensor  # ()

    @staticmethod
    def everywhere(strength=1.0, device=None) -> "AreaUniforms":
        """The area of type 0: weight `strength` at every position."""
        def f32(v):
            return torch.tensor(v, dtype=torch.float32, device=device)

        return AreaUniforms(
            type=torch.tensor(0, dtype=torch.int32, device=device),
            center=f32([0.0, 0.0, 0.0]), size=f32([1.0, 1.0, 1.0]),
            falloff=f32(1.0), rotation=f32([0.0, 0.0, 0.0, 1.0]),
            strength=f32(strength))


def area_weight(position_xyz, a: AreaUniforms):
    """computeWeight (FMA.fx:15-20): 1 - saturate(d / max(falloff, 1)) of
    the area's distance, times `strength`; type 0 weighs `strength`
    everywhere."""
    d = sdf_primitives.evaluate_by_type(a.type, position_xyz, a.center,
                                        a.size, a.rotation)
    w = 1.0 - torch.clamp(d / torch.clamp(a.falloff, min=1.0), 0.0, 1.0)
    w = torch.where(a.type == 0, 1.0, w)
    return w * a.strength


@dataclasses.dataclass
class TransformArea:
    """Host-side area config (ParticleTransform.cs:35)."""

    type: int = 0  # sdf_primitives.TYPE_* (0 = everywhere)
    center: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    size: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    falloff: float = 1.0
    rotation_z: float = 0.0  # radians about z

    def uniforms(self, strength: float, device=None) -> AreaUniforms:
        h = self.rotation_z * 0.5

        def up(name, value, dtype=torch.float32):
            return cached_upload(self, name, value, device, dtype)

        return AreaUniforms(
            type=up("type", self.type, torch.int32),
            center=up("center", self.center), size=up("size", self.size),
            falloff=up("falloff", self.falloff),
            rotation=up("rotation", [0.0, 0.0, math.sin(h), math.cos(h)]),
            strength=up("strength", strength))


def _category_mask(velocity, filter_min_max):
    return check_category_filter(velocity[:, 3], filter_min_max)


def _live_in_filter(position, velocity, category_filter):
    return ((position[:, 3] > 0.0)
            & _category_mask(velocity, category_filter))[:, None]


# --------------------------------------------------------------------------
# FMA (Transforms.cs:16-50, FMA.fx)


@tensor_dataclass
class FMAUniforms:
    area: AreaUniforms
    position_add: torch.Tensor  # (4,)
    position_multiply: torch.Tensor  # (4,)
    velocity_add: torch.Tensor  # (4,)
    velocity_multiply: torch.Tensor  # (4,)
    cycles_per_second: torch.Tensor  # (); < 0 = no time scaling
    category_filter: torch.Tensor  # (2,)


def apply_fma(position, velocity, u: FMAUniforms, su: SystemUniforms):
    """p += (p * multiply + add - p) * t, the same for v, on live particles
    in the category filter; the w lanes keep (multiply 1, add 0)."""
    w = area_weight(position[:, :3], u.area)
    t = _time_weight(w, u.cycles_per_second, su)[:, None]
    live = _live_in_filter(position, velocity, u.category_filter)
    new_pos = position + (position * u.position_multiply
                          + u.position_add - position) * t
    new_vel = velocity + (velocity * u.velocity_multiply
                          + u.velocity_add - velocity) * t
    return (torch.where(live, new_pos, position),
            torch.where(live, new_vel, velocity))


@dataclasses.dataclass
class FMA:
    """Position/velocity multiply-add force (Transforms.cs:16)."""

    position_add: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    position_multiply: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    velocity_add: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    velocity_multiply: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    cycles_per_second: Optional[float] = 10.0
    strength: float = 1.0
    area: TransformArea = dataclasses.field(default_factory=TransformArea)
    category_filter: Tuple[float, float] = (-1e9, 1e9)
    is_spawner = False

    def uniforms(self, now: float, device=None) -> FMAUniforms:
        def up(name, value):
            return cached_upload(self, name, value, device)

        return FMAUniforms(
            area=self.area.uniforms(self.strength, device),
            position_add=up("position_add", (*self.position_add, 0.0)),
            position_multiply=up("position_multiply",
                                 (*self.position_multiply, 1.0)),
            velocity_add=up("velocity_add", (*self.velocity_add, 0.0)),
            velocity_multiply=up("velocity_multiply",
                                 (*self.velocity_multiply, 1.0)),
            cycles_per_second=up("cps", _cps(self.cycles_per_second)),
            category_filter=up("category_filter", self.category_filter))


# --------------------------------------------------------------------------
# MatrixMultiply (Transforms.cs:52-71, MatrixMultiply.fx)


@tensor_dataclass
class MatrixMultiplyUniforms:
    area: AreaUniforms
    position_matrix: torch.Tensor  # (4, 4) row-vector convention
    velocity_matrix: torch.Tensor  # (4, 4)
    cycles_per_second: torch.Tensor  # ()
    category_filter: torch.Tensor  # (2,)


def apply_matrix_multiply(position, velocity, u: MatrixMultiplyUniforms,
                          su: SystemUniforms):
    """p += (mul3(p, M) - p) * t, the same for v (w lanes kept)."""
    w = area_weight(position[:, :3], u.area)
    t = _time_weight(w, u.cycles_per_second, su)[:, None]
    live = _live_in_filter(position, velocity, u.category_filter)
    new_pos = position + (mul_point_rows(position, u.position_matrix)
                          - position) * t
    new_vel = velocity + (mul_point_rows(velocity, u.velocity_matrix)
                          - velocity) * t
    return (torch.where(live, new_pos, position),
            torch.where(live, new_vel, velocity))


@dataclasses.dataclass
class MatrixMultiply:
    position_matrix: np.ndarray = dataclasses.field(
        default_factory=lambda: np.eye(4, dtype=np.float32))
    velocity_matrix: np.ndarray = dataclasses.field(
        default_factory=lambda: np.eye(4, dtype=np.float32))
    cycles_per_second: Optional[float] = 10.0
    strength: float = 1.0
    area: TransformArea = dataclasses.field(default_factory=TransformArea)
    category_filter: Tuple[float, float] = (-1e9, 1e9)
    is_spawner = False

    def uniforms(self, now: float, device=None) -> MatrixMultiplyUniforms:
        def up(name, value):
            return cached_upload(self, name, value, device)

        return MatrixMultiplyUniforms(
            area=self.area.uniforms(self.strength, device),
            position_matrix=up("position_matrix", self.position_matrix),
            velocity_matrix=up("velocity_matrix", self.velocity_matrix),
            cycles_per_second=up("cps", _cps(self.cycles_per_second)),
            category_filter=up("category_filter", self.category_filter))


# --------------------------------------------------------------------------
# Gravity (Transforms.cs:309-372, Gravity.fx)

FALLOFF_PHYSICAL = 0  # 1/d^2
FALLOFF_LINEAR = 1
FALLOFF_EXPONENTIAL = 2


@tensor_dataclass
class GravityUniforms:
    positions: torch.Tensor  # (A, 3)
    radiuses: torch.Tensor  # (A,)
    strengths: torch.Tensor  # (A,)
    falloff_types: torch.Tensor  # (A,)
    active: torch.Tensor  # (A,)
    maximum_acceleration: torch.Tensor  # ()
    category_filter: torch.Tensor  # (2,)


def apply_gravity(position, velocity, u: GravityUniforms,
                  su: SystemUniforms):
    """Gravity.fx:12-61 over (N, 4) state rows -> (position, velocity)."""
    to_center = u.positions[None, :, :] - position[:, None, :3]  # (N, A, 3)
    dist_sq = torch.sum(to_center * to_center, dim=-1)
    dist = torch.sqrt(torch.clamp(dist_sq, min=1e-12))

    att_linear = 1.0 - torch.clamp(dist / torch.clamp(u.radiuses, min=1e-6),
                                   0.0, 1.0)
    att_exp = att_linear * att_linear
    att_ramped = torch.where(u.falloff_types >= 1.5, att_exp, att_linear)
    att_ramped = att_ramped * su.dt  # Gravity.fx:41
    # Physical falloff has no dt scaling (Gravity.fx:45).
    att_physical = 1.0 / torch.clamp(dist_sq - u.radiuses, min=0.001)
    attraction = torch.where(u.falloff_types >= 0.5, att_ramped,
                             att_physical)
    accel = (to_center / dist[..., None]
             * (attraction * u.strengths * u.active)[..., None])
    accel = torch.sum(accel, dim=1)  # (N, 3)

    max_accel = u.maximum_acceleration * su.dt
    alen = torch.sqrt(torch.clamp(torch.sum(accel * accel, dim=-1),
                                  min=1e-12))
    accel = accel * torch.clamp(max_accel / alen, max=1.0)[:, None]

    live = _live_in_filter(position, velocity, u.category_filter)
    # Componentwise min with the scalar max velocity (Gravity.fx:58-60).
    new_v = torch.minimum(velocity[:, :3] + accel, su.maximum_velocity)
    new_velocity = torch.cat([new_v, velocity[:, 3:4]], dim=-1)
    return position, torch.where(live, new_velocity, velocity)


@dataclasses.dataclass
class Attractor:
    position: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    radius: float = 1.0
    strength: float = 1.0
    falloff_type: int = FALLOFF_LINEAR


@dataclasses.dataclass
class Gravity:
    attractors: list = dataclasses.field(default_factory=list)
    maximum_acceleration: float = 1e6
    category_filter: Tuple[float, float] = (-1e9, 1e9)
    is_spawner = False

    def uniforms(self, now: float, device=None) -> GravityUniforms:
        if len(self.attractors) > MAX_ATTRACTORS:
            raise ValueError(
                f"at most {MAX_ATTRACTORS} attractors (Gravity.fx:3)")
        # Padded to a multiple of 2, like the JAX package.
        a = max(-(-len(self.attractors) // 2) * 2, 2)
        pos = np.zeros((a, 3), np.float32)
        rad = np.ones((a,), np.float32)
        stren = np.zeros((a,), np.float32)
        fall = np.zeros((a,), np.float32)
        act = np.zeros((a,), np.float32)
        for i, at in enumerate(self.attractors):
            pos[i] = at.position
            rad[i] = at.radius
            stren[i] = at.strength
            fall[i] = float(at.falloff_type)
            act[i] = 1.0

        def up(name, value):
            return cached_upload(self, name, value, device)

        return GravityUniforms(
            positions=up("positions", pos), radiuses=up("radiuses", rad),
            strengths=up("strengths", stren),
            falloff_types=up("falloff_types", fall),
            active=up("active", act),
            maximum_acceleration=up("maximum_acceleration",
                                    self.maximum_acceleration),
            category_filter=up("category_filter", self.category_filter))


# --------------------------------------------------------------------------
# Noise / SpatialNoise (Transforms.cs:133-307, Noise.fx)


@tensor_dataclass
class NoiseUniforms:
    area: AreaUniforms
    position_offset: torch.Tensor  # (4,)
    position_minimum: torch.Tensor  # (4,)
    position_scale: torch.Tensor  # (4,)
    velocity_offset: torch.Tensor  # (4,)
    velocity_minimum: torch.Tensor  # (4,)
    velocity_scale: torch.Tensor  # (4,)
    replace_old_velocity: torch.Tensor  # ()
    cycles_per_second: torch.Tensor  # ()
    frequency_lerp: torch.Tensor  # ()
    randomness_offset: torch.Tensor  # (2,)
    next_randomness_offset: torch.Tensor  # (2,)
    space_scale: torch.Tensor  # (2,) (SpatialNoise only)
    category_filter: torch.Tensor  # (2,)


# Each Noise gets its own seed, as in the JAX package (the reference seeds
# a new Xoshiro per Noise).
_NOISE_SEEDS = itertools.count(1)


def _unit3(velocity):
    return velocity[:, :3] / torch.sqrt(torch.clamp(
        torch.sum(velocity[:, :3] ** 2, dim=-1, keepdim=True), min=1e-12))


def _steer(velocity, delta, w, t, replace_old_velocity):
    """The velocity update Noise and VectorField share: replace v by
    lerp(v, delta, w) or add delta * t, then add |delta.w| along v."""
    v = velocity[:, :3]
    v_replace = v + (delta[:, :3] - v) * w[:, None]
    v_add = v + delta[:, :3] * t[:, None]
    new_v = torch.where(replace_old_velocity > 0.5, v_replace, v_add)
    new_v = new_v + _unit3(velocity) * delta[:, 3:4]
    return torch.cat([new_v, velocity[:, 3:4]], dim=-1)


def _noise_core(position, velocity, u: NoiseUniforms, su: SystemUniforms,
                random_p, random_v, apply_minimum: bool = True):
    w = area_weight(position[:, :3], u.area)
    t = _time_weight(w, u.cycles_per_second, su)
    pd = random_p + u.position_offset
    vd = random_v + u.velocity_offset
    if apply_minimum:
        # PS_Noise only (Noise.fx:40-44); PS_SpatialNoise has no minimum.
        pd = torch.sign(pd) * torch.maximum(torch.abs(pd),
                                            u.position_minimum)
        vd = torch.sign(vd) * torch.maximum(torch.abs(vd),
                                            u.velocity_minimum)
    pd = pd * u.position_scale
    vd = vd * u.velocity_scale
    new_pos = position + pd * t[:, None]
    new_vel = _steer(velocity, vd, w, t, u.replace_old_velocity)
    # Noise.fx applies regardless of life; only the category filter gates.
    live = _category_mask(velocity, u.category_filter)[:, None]
    return (torch.where(live, new_pos, position),
            torch.where(live, new_vel, velocity))


def _noise_draws(sample, field, xy, u: NoiseUniforms, *rate):
    """Position and velocity randomness, each lerped between the field at
    the current and the next randomness offset; the velocity draw reads
    the field at xy + (2, 1)."""
    fl = u.frequency_lerp
    out = []
    shifted = torch.stack([xy[..., 0] + 2.0, xy[..., 1] + 1.0], dim=-1)
    for at in (xy, shifted):
        a = sample(field, at, u.randomness_offset, *rate)
        b = sample(field, at, u.next_randomness_offset, *rate)
        out.append(a + (b - a) * fl)
    return out


def apply_noise(position, velocity, u: NoiseUniforms, su: SystemUniforms,
                field: noise_ops.RandomField, slot_xy):
    """Temporal noise (PS_Noise, Noise.fx:28-72): per-slot randomness
    interpolated between two random field offsets over the interval."""
    random_p, random_v = _noise_draws(noise_ops.point_sample, field,
                                      slot_xy, u)
    return _noise_core(position, velocity, u, su, random_p, random_v)


def apply_spatial_noise(position, velocity, u: NoiseUniforms,
                        su: SystemUniforms, field: noise_ops.RandomField,
                        slot_xy):
    """PS_SpatialNoise (Noise.fx:74-116): position-indexed smooth
    randomness, a procedural vector field. `slot_xy` is unused (kept for
    the signature both noise routes share)."""
    random_p, random_v = _noise_draws(noise_ops.bilinear_sample, field,
                                      position[:, :2], u, u.space_scale)
    return _noise_core(position, velocity, u, su, random_p, random_v,
                       apply_minimum=False)


@dataclasses.dataclass
class Noise:
    """Time-interpolated random force (Transforms.cs:133). The host cycles
    the randomness offsets every `interval_seconds` from its own numpy
    stream, draw for draw as the JAX package does."""

    interval_seconds: float = 1.0
    position_offset: Tuple[float, float, float, float] = (-0.5,) * 4
    position_minimum: Tuple[float, float, float, float] = (0.0,) * 4
    position_scale: Tuple[float, float, float, float] = (0.0,) * 4
    velocity_offset: Tuple[float, float, float, float] = (-0.5,) * 4
    velocity_minimum: Tuple[float, float, float, float] = (0.0,) * 4
    velocity_scale: Tuple[float, float, float, float] = (1.0,) * 3 + (0.0,)
    replace_old_velocity: bool = True
    cycles_per_second: Optional[float] = 10.0
    strength: float = 1.0
    area: TransformArea = dataclasses.field(default_factory=TransformArea)
    category_filter: Tuple[float, float] = (-1e9, 1e9)
    space_scale: Tuple[float, float] = (1.0, 1.0)
    spatial: bool = False
    is_spawner = False
    _rng: np.random.Generator = dataclasses.field(
        default_factory=lambda: np.random.default_rng(next(_NOISE_SEEDS)),
        repr=False)
    _offset_a: Tuple[float, float] = (0.0, 0.0)
    _offset_b: Tuple[float, float] = (37.0, 59.0)
    _last_cycle: int = -1

    def _maybe_cycle(self, now: float):
        if self.interval_seconds <= 0.01:
            # AutoCycleUV: an interval <= 0.01 freezes the field.
            return
        cycle = int(now / max(self.interval_seconds, 1e-6))
        if cycle != self._last_cycle:
            self._last_cycle = cycle
            self._offset_a = self._offset_b
            self._offset_b = (float(self._rng.uniform(0, 253)),
                              float(self._rng.uniform(0, 127)))

    def uniforms(self, now: float, device=None) -> NoiseUniforms:
        self._maybe_cycle(now)
        frac = (0.0 if self.interval_seconds <= 0.01
                else (now / self.interval_seconds) % 1.0)

        def up(name, value):
            return cached_upload(self, name, value, device)

        # The shader rate is the reciprocal of SpaceScale (SetParameters).
        space = 1.0 / np.maximum(np.asarray(self.space_scale, np.float32),
                                 np.float32(1e-6))
        return NoiseUniforms(
            area=self.area.uniforms(self.strength, device),
            position_offset=up("position_offset", self.position_offset),
            position_minimum=up("position_minimum", self.position_minimum),
            position_scale=up("position_scale", self.position_scale),
            velocity_offset=up("velocity_offset", self.velocity_offset),
            velocity_minimum=up("velocity_minimum", self.velocity_minimum),
            velocity_scale=up("velocity_scale", self.velocity_scale),
            replace_old_velocity=up("replace_old_velocity",
                                    1.0 if self.replace_old_velocity
                                    else 0.0),
            cycles_per_second=up("cps", _cps(self.cycles_per_second)),
            frequency_lerp=up("frequency_lerp", frac),
            randomness_offset=up("randomness_offset", self._offset_a),
            next_randomness_offset=up("next_randomness_offset",
                                      self._offset_b),
            space_scale=up("space_scale", space),
            category_filter=up("category_filter", self.category_filter))


def spatial_noise(**kwargs) -> Noise:
    return Noise(spatial=True, **kwargs)


# --------------------------------------------------------------------------
# VectorField force (VectorField.cs:10-51 + config-4 usage): a (H, W, 4)
# field sampled bilinearly at particle xy drives velocity.


@tensor_dataclass
class VectorFieldUniforms:
    area: AreaUniforms
    field: torch.Tensor  # (H, W, 4)
    field_scale: torch.Tensor  # (2,) world xy -> field texel scale
    field_offset: torch.Tensor  # (2,)
    velocity_scale: torch.Tensor  # (4,) xyz force scale + w along velocity
    replace_old_velocity: torch.Tensor  # ()
    cycles_per_second: torch.Tensor  # ()
    category_filter: torch.Tensor  # (2,)


def apply_vector_field(position, velocity, u: VectorFieldUniforms,
                       su: SystemUniforms):
    w = area_weight(position[:, :3], u.area)
    t = _time_weight(w, u.cycles_per_second, su)
    sample = noise_ops.bilinear_sample(
        noise_ops.RandomField(data=u.field), position[:, :2], u.field_offset,
        u.field_scale)
    # Field xy(z) channels are signed directions; scale per axis.
    new_vel = _steer(velocity, sample * u.velocity_scale, w, t,
                     u.replace_old_velocity)
    live = _live_in_filter(position, velocity, u.category_filter)
    return position, torch.where(live, new_vel, velocity)


@dataclasses.dataclass
class VectorField:
    """Texture-driven force field."""

    field: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((8, 8, 4), np.float32))
    field_scale: Tuple[float, float] = (1.0, 1.0)
    field_offset: Tuple[float, float] = (0.0, 0.0)
    velocity_scale: Tuple[float, float, float, float] = (1.0, 1.0, 0.0, 0.0)
    replace_old_velocity: bool = False
    cycles_per_second: Optional[float] = 10.0
    strength: float = 1.0
    area: TransformArea = dataclasses.field(default_factory=TransformArea)
    category_filter: Tuple[float, float] = (-1e9, 1e9)
    is_spawner = False

    def _device_field(self, device):
        # Uploaded once per field object and device (the JAX package
        # caches by identity too, transforms.py:589): assign a new array
        # to change the field.
        cached = getattr(self, "_field_dev", None)
        if cached is None or cached[0] is not self.field or \
                cached[1] != str(device):
            cached = (self.field, str(device),
                      cached_upload(self, "field", self.field, device))
            self._field_dev = cached
        return cached[2]

    def uniforms(self, now: float, device=None) -> VectorFieldUniforms:
        def up(name, value):
            return cached_upload(self, name, value, device)

        return VectorFieldUniforms(
            area=self.area.uniforms(self.strength, device),
            field=self._device_field(device),
            field_scale=up("field_scale", self.field_scale),
            field_offset=up("field_offset", self.field_offset),
            velocity_scale=up("velocity_scale", self.velocity_scale),
            replace_old_velocity=up("replace_old_velocity",
                                    1.0 if self.replace_old_velocity
                                    else 0.0),
            cycles_per_second=up("cps", _cps(self.cycles_per_second)),
            category_filter=up("category_filter", self.category_filter))


# --------------------------------------------------------------------------
# The tick's ordered modifier chain (ParticleSystem.cs:800-817)


def slot_xy(capacity: int, device=None):
    """Flat slot index -> the reference's 256-wide chunk texel grid (the
    randomness sampling coordinates, ParticleSystem.cs:49): (capacity, 2)
    float32 (i % 256, floor(i / 256))."""
    i = torch.arange(capacity, dtype=torch.float32, device=device)
    return torch.stack([i % 256.0, torch.floor(i / 256.0)], dim=-1)


_NOISE_STEPS = (apply_noise, apply_spatial_noise)


def apply_modifiers(position, velocity, steps, su: SystemUniforms,
                    random_field: Optional[noise_ops.RandomField] = None):
    """Run a tick's modifiers in order: `steps` is a sequence of (eager
    function, uniforms) pairs, the function one of this module's `apply_*`
    (the noise steps sample `random_field`). On CUDA tensors the chain is
    one launch of K4c (particles/modifier_kernel.py), which equals it bit
    for bit; elsewhere `apply_modifiers_reference`."""
    if not steps:
        return position, velocity
    from . import modifier_kernel

    if modifier_kernel.takes(position.device):
        return modifier_kernel.modifiers_cuda(position, velocity, steps, su,
                                              random_field)
    return apply_modifiers_reference(position, velocity, steps, su,
                                     random_field)


def apply_modifiers_reference(position, velocity, steps, su: SystemUniforms,
                              random_field=None):
    """The plain version of `apply_modifiers` on any device: each step's
    eager function in turn, the noise steps at `slot_xy` of the rows."""
    grid = None
    for apply, u in steps:
        if apply in _NOISE_STEPS:
            if grid is None:
                grid = slot_xy(position.shape[0], position.device)
            position, velocity = apply(position, velocity, u, su,
                                       random_field, grid)
        else:
            position, velocity = apply(position, velocity, u, su)
    return position, velocity


# --------------------------------------------------------------------------
# Sensor (Transforms.cs:374-486, CollectParticles.fx): counts live
# particles inside an area with one masked reduction.


@dataclasses.dataclass
class Sensor:
    """Analyzer transform: does not modify particles (IsAnalyzer)."""

    area: TransformArea = dataclasses.field(default_factory=TransformArea)
    category_filter: Tuple[float, float] = (-1e9, 1e9)
    is_spawner = False
    is_analyzer = True
    last_count: int = 0

    def uniforms(self, now: float, device=None) -> AreaUniforms:
        return self.area.uniforms(1.0, device)

    def measure(self, state) -> int:
        """Count live particles (life > 1, CollectParticles.fx:32) in the
        category filter whose area weight exceeds 0.01; one device read."""
        dev = state.position.device
        w = area_weight(state.position[:, :3], self.uniforms(0.0, dev))
        live = state.position[:, 3] > 1.0
        cat = check_category_filter(
            state.velocity[:, 3],
            cached_upload(self, "category_filter", self.category_filter,
                          dev))
        self.last_count = int(torch.sum((live & cat & (w > 0.01))
                                        .to(torch.int32)))
        return self.last_count


def _trs_matrix(pre_translate, pre_scale, rotation_xyz, post_translate,
                post_scale):
    """GeometricTransform matrix (Transforms.cs:81-107), on the host in
    float32: row-vector pre-translate * pre-scale * rotation (YawPitchRoll)
    * post-scale * post-translate."""
    def translation(t):
        m = np.eye(4, dtype=np.float32)
        m[3, :3] = t
        return m

    def scale(s):
        m = np.eye(4, dtype=np.float32)
        m[0, 0] = m[1, 1] = m[2, 2] = s
        return m

    rx, ry, rz = rotation_xyz
    cy, sy = math.cos(ry), math.sin(ry)
    cp, sp_ = math.cos(rx), math.sin(rx)
    cr, sr = math.cos(rz), math.sin(rz)
    # Yaw (y) * Pitch (x) * Roll (z), XNA row-vector convention.
    m_y = np.asarray([[cy, 0, -sy, 0], [0, 1, 0, 0], [sy, 0, cy, 0],
                      [0, 0, 0, 1]], np.float32)
    m_x = np.asarray([[1, 0, 0, 0], [0, cp, sp_, 0], [0, -sp_, cp, 0],
                      [0, 0, 0, 1]], np.float32)
    m_z = np.asarray([[cr, sr, 0, 0], [-sr, cr, 0, 0], [0, 0, 1, 0],
                      [0, 0, 0, 1]], np.float32)
    rot = m_z @ m_x @ m_y
    return (translation(pre_translate) @ scale(pre_scale) @ rot
            @ scale(post_scale) @ translation(post_translate))


@dataclasses.dataclass
class GeometricTransform(MatrixMultiply):
    """TRS-decomposed matrix transform (Transforms.cs:73-131): a
    MatrixMultiply with host-computed matrices."""

    position_pre_translate: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    position_pre_scale: float = 1.0
    position_rotation: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    position_post_translate: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    position_post_scale: float = 1.0
    velocity_rotation: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    velocity_scale: float = 1.0

    def uniforms(self, now: float, device=None) -> MatrixMultiplyUniforms:
        self.position_matrix = _trs_matrix(
            self.position_pre_translate, self.position_pre_scale,
            self.position_rotation, self.position_post_translate,
            self.position_post_scale)
        self.velocity_matrix = _trs_matrix(
            (0.0, 0.0, 0.0), 1.0, self.velocity_rotation, (0.0, 0.0, 0.0),
            self.velocity_scale)
        return super().uniforms(now, device)
