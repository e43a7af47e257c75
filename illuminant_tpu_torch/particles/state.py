"""Particle state: fixed-capacity SoA tensors and a ring write cursor.

Counterpart of illuminant_tpu/particles/state.py. Channel semantics
(ParticleCommon.fxh): position.w = life (<= 0 dead); velocity.w = category
/ bounce-delay counter; color = spawn attribute; render_color = post-ramp
premultiplied color; render_data = (size, rotation, |velocity|,
velocity.w).
"""

from __future__ import annotations

import torch

from ..core.pytree import tensor_dataclass


@tensor_dataclass
class ParticleState:
    position: torch.Tensor  # (N, 4) xyz + life
    velocity: torch.Tensor  # (N, 4) xyz + category
    color: torch.Tensor  # (N, 4)
    render_color: torch.Tensor  # (N, 4)
    render_data: torch.Tensor  # (N, 4)
    write_cursor: torch.Tensor  # () int32
    total_spawned: torch.Tensor  # () int32

    @property
    def capacity(self) -> int:
        return self.position.shape[0]

    @staticmethod
    def empty(capacity: int, device=None) -> "ParticleState":
        n = capacity
        f32 = torch.float32

        def zeros():
            return torch.zeros((n, 4), dtype=f32, device=device)

        return ParticleState(
            position=zeros(), velocity=zeros(),
            color=torch.ones((n, 4), dtype=f32, device=device),
            render_color=zeros(), render_data=zeros(),
            write_cursor=torch.zeros((), dtype=torch.int32, device=device),
            total_spawned=torch.zeros((), dtype=torch.int32, device=device),
        )

    def live_mask(self):
        return self.position[:, 3] > 0.0

    def live_count(self):
        return torch.sum(self.live_mask().to(torch.int32))


@tensor_dataclass
class SystemUniforms:
    """Per-update uniforms (ParticleCommon.fxh:29-37), dt in seconds.

    global_settings = (dt, friction, maximum_velocity, life_decay);
    collision_settings = (escape_velocity, bounce_velocity_multiplier,
    collision_distance, collision_life_penalty); animation_and_rotation =
    (animation_rate_x, animation_rate_y, velocity_rotation, z_to_y)."""

    global_settings: torch.Tensor
    collision_settings: torch.Tensor
    animation_and_rotation: torch.Tensor

    @staticmethod
    def make(dt=1.0 / 60, friction=0.0, maximum_velocity=16384.0,
             life_decay=1.0, escape_velocity=128.0,
             bounce_velocity_multiplier=0.0, collision_distance=0.33,
             collision_life_penalty=0.0, animation_rate=(0.0, 0.0),
             velocity_rotation=0.0, z_to_y=0.0,
             device=None) -> "SystemUniforms":
        def f32(v):
            return torch.tensor(v, dtype=torch.float32, device=device)

        return SystemUniforms(
            global_settings=f32([dt, friction, maximum_velocity,
                                 life_decay]),
            collision_settings=f32([escape_velocity,
                                    bounce_velocity_multiplier,
                                    collision_distance,
                                    collision_life_penalty]),
            animation_and_rotation=f32([animation_rate[0], animation_rate[1],
                                        velocity_rotation, z_to_y]),
        )

    @property
    def dt(self):
        return self.global_settings[0]

    @property
    def friction(self):
        return self.global_settings[1]

    @property
    def maximum_velocity(self):
        return self.global_settings[2]

    @property
    def life_decay(self):
        return self.global_settings[3]


def friction_and_maximum_length(length, uniforms: SystemUniforms):
    """The speed after applyFrictionAndMaximum (UpdateCommon.fxh:20-35):
    |v| clamped to the maximum, slowed by friction over dt, in [0, max]."""
    max_v = uniforms.maximum_velocity
    clamped = torch.minimum(length, max_v)
    friction = clamped * uniforms.friction
    return torch.minimum(
        torch.clamp(clamped - friction * uniforms.dt, min=0.0), max_v)


def apply_friction_and_maximum(velocity, uniforms: SystemUniforms):
    """applyFrictionAndMaximum (UpdateCommon.fxh:20-35) on (..., 3): the
    unit direction times the new speed, 0 where |v| <= 0.001."""
    length = torch.sqrt(torch.clamp(torch.sum(velocity * velocity, dim=-1),
                                    min=1e-20))
    new_l = friction_and_maximum_length(length, uniforms)
    result = velocity / length[..., None] * new_l[..., None]
    return torch.where(length[..., None] <= 0.001, 0.0, result)


def check_category_filter(category, filter_min_max):
    """checkCategoryFilter (ParticleCommon.fxh:198-200)."""
    return (category >= filter_min_max[0]) & (category <= filter_min_max[1])
