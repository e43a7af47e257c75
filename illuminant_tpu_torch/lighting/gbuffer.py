"""The 2.5D G-buffer (counterpart of illuminant_tpu/lighting/gbuffer.py).

Planar struct-of-arrays: normal (H, W, 3), relative_y / z (H, W), and
enable_shadows / fullbright (H, W) 0/1 flags. `world_position()`
reconstructs shading positions as sampleGBuffer does: world.xy =
pixel.xy / render_scale + (0, relativeY), world.z from the buffer.
`window()` cuts the bounded view of a windowed light
(lighting/windowed.py); its `pixel_origin` keeps the view's place in the
full frame.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.pytree import tensor_dataclass
from .environment import EnvironmentUniforms


@tensor_dataclass
class GBuffer:
    """`pixel_origin` ((2,) float32 [ox, oy], or None for the full frame):
    the pixel coordinate of this buffer's top-left corner in the full
    frame, non-zero for the views `window()` cuts."""

    normal: torch.Tensor
    relative_y: torch.Tensor
    z: torch.Tensor
    enable_shadows: torch.Tensor
    fullbright: torch.Tensor
    render_scale: float = 1.0
    pixel_origin: Optional[torch.Tensor] = None

    def _origin(self):
        if self.pixel_origin is None:
            return torch.zeros((2,), dtype=torch.float32,
                               device=self.z.device)
        return self.pixel_origin.to(torch.float32)

    @property
    def shape(self):
        return tuple(self.z.shape)

    def _pixel_grid(self):
        h, w = self.z.shape
        dev = self.z.device
        o = self._origin()
        ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5 + o[1]) \
            / self.render_scale
        xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5 + o[0]) \
            / self.render_scale
        return torch.meshgrid(ys, xs, indexing="ij")

    def world_position(self):
        """Shaded world positions (H, W, 3) (LightCommon.fxh:118-122 with
        viewport scale 1, position 0)."""
        gy, gx = self._pixel_grid()
        return torch.stack([gx, gy + self.relative_y, self.z], dim=-1)

    def camera_position(self, env: EnvironmentUniforms):
        """Approximate per-pixel camera position (H, W, 3)
        (LightCommon.fxh:98-99): straight above each pixel at
        maximum_z + 0.01."""
        gy, gx = self._pixel_grid()
        cz = torch.broadcast_to(env.maximum_z + 0.01, gx.shape)
        return torch.stack([gx, gy, cz], dim=-1)

    def window(self, oy: int, ox: int, win_h: int, win_w: int) -> "GBuffer":
        """The (win_h, win_w) view at pixel origin (oy, ox), Python ints
        the caller has clamped into bounds (windowed.window_origin)."""

        def cut(a):
            return a[oy:oy + win_h, ox:ox + win_w]

        origin = self._origin() + torch.tensor(
            [float(ox), float(oy)], dtype=torch.float32, device=self.z.device)
        return GBuffer(
            normal=cut(self.normal), relative_y=cut(self.relative_y),
            z=cut(self.z), enable_shadows=cut(self.enable_shadows),
            fullbright=cut(self.fullbright), render_scale=self.render_scale,
            pixel_origin=origin)


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


def no_gbuffer(height: int, width: int, env: EnvironmentUniforms,
               render_scale: float = 1.0) -> GBuffer:
    """The EnableGBuffer=false path (LightCommon.fxh:132-141): every pixel
    is the ground plane with a +z normal and shadows enabled."""
    return flat_ground(height, width, env, render_scale, enable_shadows=True)
