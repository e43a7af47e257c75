"""The 2.5D G-buffer (counterpart of illuminant_tpu/lighting/gbuffer.py,
the flat-ground buffer the flagship frame shades).

Planar struct-of-arrays: normal (H, W, 3), relative_y / z (H, W), and
enable_shadows / fullbright (H, W) 0/1 flags. Windowed views
(`pixel_origin`, `window`) belong to the bounded light families and are
not ported yet (ROADMAP M9).
"""

from __future__ import annotations

import torch

from ..core.pytree import tensor_dataclass
from .environment import EnvironmentUniforms


@tensor_dataclass
class GBuffer:
    normal: torch.Tensor
    relative_y: torch.Tensor
    z: torch.Tensor
    enable_shadows: torch.Tensor
    fullbright: torch.Tensor
    render_scale: float = 1.0

    @property
    def shape(self):
        return tuple(self.z.shape)


def flat_ground(height: int, width: int, env: EnvironmentUniforms,
                render_scale: float = 1.0,
                enable_shadows: bool = True) -> GBuffer:
    """Ground-plane-only G-buffer (RenderGroundPlane,
    LightingRenderer.GBuffer.cs:271-329): normal +z, z = ground_z."""
    h, w = height, width
    dev = env.ground_z.device
    normal = torch.zeros((h, w, 3), dtype=torch.float32, device=dev)
    normal[..., 2] = 1.0
    return GBuffer(
        normal=normal,
        relative_y=torch.zeros((h, w), dtype=torch.float32, device=dev),
        z=torch.broadcast_to(env.ground_z, (h, w)).to(torch.float32)
        .contiguous(),
        enable_shadows=torch.full((h, w), 1.0 if enable_shadows else 0.0,
                                  dtype=torch.float32, device=dev),
        fullbright=torch.zeros((h, w), dtype=torch.float32, device=dev),
        render_scale=render_scale,
    )
