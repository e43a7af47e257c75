"""Per-particle render data: bezier color/size ramps and rotation.

Counterpart of illuminant_tpu/particles/render_data.py:compute_render_data
(UpdateCommon.fxh:97-117): ColorFromLife x ColorFromVelocity and
SizeFromLife x SizeFromVelocity beziers per particle, premultiplied alpha,
rotation from life and slot index. The life-ramp texture and the
velocity-direction rotation are ROADMAP M13.
"""

from __future__ import annotations

import torch

from ..core.pytree import tensor_dataclass
from ..ops.bezier import ClampedBezier, constant_bezier, evaluate_bezier


@tensor_dataclass
class RenderDataUniforms:
    color_from_life: ClampedBezier  # 4 channels
    color_from_velocity: ClampedBezier  # 4 channels
    size_from_life: ClampedBezier  # 1 channel
    size_from_velocity: ClampedBezier  # 1 channel
    rotation_from_life_and_index: torch.Tensor  # (2,)

    @staticmethod
    def defaults(size: float = 1.0, device=None) -> "RenderDataUniforms":
        return RenderDataUniforms(
            color_from_life=constant_bezier([1.0] * 4, device=device),
            color_from_velocity=constant_bezier([1.0] * 4, device=device),
            size_from_life=constant_bezier([size], device=device),
            size_from_velocity=constant_bezier([1.0], device=device),
            rotation_from_life_and_index=torch.zeros(
                (2,), dtype=torch.float32, device=device),
        )


def compute_render_data(position, velocity, attributes, index,
                        u: RenderDataUniforms):
    """(N, 4) state rows -> (render_color, render_data), zeros where the
    particle is dead."""
    life = position[..., 3]
    vel_len = torch.clamp(
        torch.sqrt(torch.sum(velocity[..., :3] ** 2, dim=-1)), min=1e-4)
    color = (evaluate_bezier(u.color_from_life, life)
             * evaluate_bezier(u.color_from_velocity, vel_len))
    render_color = attributes * color
    a = torch.clamp(render_color[..., 3:4], 0.0, 1.0)
    render_color = torch.cat([render_color[..., :3] * a, a], dim=-1)

    size = (evaluate_bezier(u.size_from_life, life)[..., 0]
            * evaluate_bezier(u.size_from_velocity, vel_len)[..., 0])
    rotation = (life * u.rotation_from_life_and_index[0]
                + index.to(torch.float32) * u.rotation_from_life_and_index[1])
    render_data = torch.stack([size, rotation, vel_len, velocity[..., 3]],
                              dim=-1)
    dead = (life <= 0.0)[..., None]
    return (torch.where(dead, 0.0, render_color),
            torch.where(dead, 0.0, render_data))
