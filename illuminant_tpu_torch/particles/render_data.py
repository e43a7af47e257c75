"""Per-particle render data: bezier color/size ramps and rotation.

Counterpart of illuminant_tpu/particles/render_data.py:compute_render_data
(UpdateCommon.fxh:97-117): ColorFromLife x ColorFromVelocity and
SizeFromLife x SizeFromVelocity beziers per particle, the optional
point-sampled life-ramp texture, premultiplied alpha, and rotation from
life, slot index and (behind the static `use_velocity_rotation` gate)
the velocity direction.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..core.pytree import tensor_dataclass
from ..ops.bezier import ClampedBezier, constant_bezier, evaluate_bezier


def pack_life_ramp_settings(strength: float = 1.0, minimum: float = 0.0,
                            maximum: float = 100.0, invert: bool = False,
                            texture_height: int = 1,
                            device=None) -> torch.Tensor:
    """LifeRampSettings uniform (ParticleSystem.cs:926-939 upload:
    strength * (invert ? -1 : 1), minimum, max(range, 0.001),
    indexDivisor = ramp texture height)."""
    range_size = max(float(maximum) - float(minimum), 0.001)
    return torch.tensor(
        [float(strength) * (-1.0 if invert else 1.0), float(minimum),
         range_size, float(max(texture_height, 1))],
        dtype=torch.float32, device=device)


@tensor_dataclass
class RenderDataUniforms:
    color_from_life: ClampedBezier  # 4 channels
    color_from_velocity: ClampedBezier  # 4 channels
    size_from_life: ClampedBezier  # 1 channel
    size_from_velocity: ClampedBezier  # 1 channel
    rotation_from_life_and_index: torch.Tensor  # (2,)
    velocity_rotation: Optional[torch.Tensor] = None  # (); None reads 0
    # ParticleColorLifeRamp (ParticleConfiguration.cs:111-137): a
    # point-sampled (RH, RW, 4) ramp blended over the bezier color by
    # |strength|; U = (life - min) / range, clamped (negative strength
    # inverts it); V = index / index_divisor, wrapped. None = off.
    life_ramp: Optional[torch.Tensor] = None
    life_ramp_settings: Optional[torch.Tensor] = None  # (4,)
    # Static gate of the velocity -> angle path (an atan2 per particle per
    # tick); ParticleSystem sets it when velocity_rotation is nonzero.
    use_velocity_rotation: bool = False

    @staticmethod
    def defaults(size: float = 1.0, device=None) -> "RenderDataUniforms":
        return RenderDataUniforms(
            color_from_life=constant_bezier([1.0] * 4, device=device),
            color_from_velocity=constant_bezier([1.0] * 4, device=device),
            size_from_life=constant_bezier([size], device=device),
            size_from_velocity=constant_bezier([1.0], device=device),
            rotation_from_life_and_index=torch.zeros(
                (2,), dtype=torch.float32, device=device),
            velocity_rotation=torch.zeros((), dtype=torch.float32,
                                          device=device),
        )


def rotation_for_velocity(velocity):
    """getRotationForVelocity (UpdateCommon.fxh:82-95): the angle of the
    xy velocity in [0, 2 pi), 0 where both components are below 0.01."""
    absvel = torch.abs(velocity[..., :2])
    angle = torch.atan2(velocity[..., 1], velocity[..., 0])
    angle = torch.where(angle < 0.0, angle + 2.0 * math.pi, angle)
    near_zero = torch.all(absvel < 0.01, dim=-1)
    return torch.where(near_zero, 0.0, angle)


def _life_ramp(color, life, index, u: RenderDataUniforms):
    """getRampedColorForLifeValueAndIndex (UpdateCommon.fxh:66-80):
    lerp(color, ramp(u, v) * color, saturate(|strength|))."""
    s = u.life_ramp_settings
    strength = s[0]
    uu = (life - s[1]) / s[2]
    uu = torch.where(strength < 0.0, 1.0 - torch.clamp(uu, 0.0, 1.0), uu)
    rh, rw = u.life_ramp.shape[:2]
    col = torch.clamp(torch.floor(uu * rw).to(torch.int64), 0, rw - 1)
    row = torch.remainder(
        torch.floor(index.to(torch.float32) / s[3] * rh).to(torch.int64), rh)
    texel = u.life_ramp[row, col]
    blend = torch.clamp(torch.abs(strength), 0.0, 1.0)
    return color + (texel * color - color) * blend


def compute_render_data(position, velocity, attributes, index,
                        u: RenderDataUniforms):
    """(N, 4) state rows -> (render_color, render_data), zeros where the
    particle is dead."""
    life = position[..., 3]
    vel_len = torch.clamp(
        torch.sqrt(torch.sum(velocity[..., :3] ** 2, dim=-1)), min=1e-4)
    color = (evaluate_bezier(u.color_from_life, life)
             * evaluate_bezier(u.color_from_velocity, vel_len))
    if u.life_ramp is not None:
        color = _life_ramp(color, life, index, u)
    render_color = attributes * color
    a = torch.clamp(render_color[..., 3:4], 0.0, 1.0)
    render_color = torch.cat([render_color[..., :3] * a, a], dim=-1)

    size = (evaluate_bezier(u.size_from_life, life)[..., 0]
            * evaluate_bezier(u.size_from_velocity, vel_len)[..., 0])
    rotation = (life * u.rotation_from_life_and_index[0]
                + index.to(torch.float32) * u.rotation_from_life_and_index[1])
    if u.use_velocity_rotation and u.velocity_rotation is not None:
        rotation = rotation + (rotation_for_velocity(velocity)
                               * u.velocity_rotation)
    render_data = torch.stack([size, rotation, vel_len, velocity[..., 3]],
                              dim=-1)
    dead = (life <= 0.0)[..., None]
    return (torch.where(dead, 0.0, render_color),
            torch.where(dead, 0.0, render_data))

