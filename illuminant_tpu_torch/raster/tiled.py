"""Additive particle rasterization (counterpart of
illuminant_tpu/raster/tiled.py:rasterize_tiled).

The JAX package bins particles by 32-px screen tile with a sort, slices
fixed-capacity bins, and splats each tile's separable coverage as one-hot
matmuls on the MXU, overlap-adding tile windows that reach `apron` pixels
past their tile. The port computes the same image as a direct additive
splat: each live on-screen particle adds color x wy(row) x wx(col) of the
same coverage profile (`_profile`) to every pixel of its footprint that
lies inside its tile's window. The sort-key packing, rgba8 / compact
payloads, the int8 splat and the overflow level are TPU machinery and are
not ported, so colors, positions and sizes stay float32 (the JAX fast
preset quantizes them: tiled.py:544, 659, 693) and no particle is ever
dropped for bin capacity. The parity preset (the round kernel with float
colours, scenes.py:544-550) is the same splat with `kernel="round"`; the
JAX parity frame keeps bf16 colours and a fixed bin capacity, so it can
report `dropped > 0` where the port reports 0.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

KERNEL_QUAD = "quad"
KERNEL_GAUSS = "gauss"
KERNEL_ROUND = "round"


@dataclasses.dataclass(frozen=True)
class TiledRasterConfig:
    """The raster parameters the direct splat reads, with the JAX
    package's meanings: each particle covers the pixels of its screen
    tile's window, `tile` pixels plus `apron` on every side."""

    height: int
    width: int
    tile: int = 32
    apron: int = 4
    kernel: str = KERNEL_GAUSS
    channels: int = 4
    # Stipple phase offset, read by raster/render.py (per system, so that
    # stippled systems interleave).
    stipple_offset: float = 0.0

    @property
    def grid(self) -> Tuple[int, int]:
        return -(-self.height // self.tile), -(-self.width // self.tile)

    @property
    def window(self) -> int:
        return self.tile + 2 * self.apron


def _profile(kernel: str, d, radius):
    """1-D coverage at signed distance d from the center (tiled.py:
    228-268); the 2-D footprint is the product of a row and a column
    profile."""
    if kernel == KERNEL_QUAD:
        return torch.clamp(radius - torch.abs(d) + 0.5, 0.0, 1.0)
    if kernel == KERNEL_GAUSS:
        # sigma = r/2; exp(-q) as the squaring chain (1 - q/8)^8, which
        # has exact compact support |d| < 4 sigma.
        sigma = torch.clamp(radius * 0.5, min=0.3)
        q = 0.5 * (d / sigma) ** 2
        base = torch.clamp(1.0 - q * 0.125, min=0.0)
        b2 = base * base
        b4 = b2 * b2
        return b4 * b4
    if kernel == KERNEL_ROUND:
        # Smooth edge whose product approximates computeCircularAlpha
        # (RasterizeParticleSystem.fx:145-156).
        t = torch.clamp(radius - torch.abs(d) + 0.5, 0.0, 1.0)
        edge = torch.clamp(torch.abs(d) / torch.clamp(radius, min=0.5),
                           0.0, 1.0)
        u = edge * edge
        return t * (0.99924356 - (0.24155038 + 0.04961871 * u) * u)
    raise ValueError(f"unknown kernel {kernel!r}")


def _support(kernel: str, radius: float) -> float:
    """Half-width in pixels beyond which `_profile` is exactly 0."""
    if kernel == KERNEL_GAUSS:
        return 4.0 * max(radius * 0.5, 0.3)
    return radius + 0.5


def rasterize_tiled(cfg: TiledRasterConfig, x, y, color, size, live):
    """Additive rasterization. x, y (N,) screen positions; color (N, >=C)
    premultiplied HDR; size (N,) quad edge in pixels; live (N,) bool.
    Returns (image (H, W, C) float32, {"dropped": 0}) with C =
    cfg.channels.

    Live on-screen particles are gathered first and the footprint extent
    is read from their largest radius: two device-to-host reads per
    call."""
    H, W, T, A = cfg.height, cfg.width, cfg.tile, cfg.apron
    gy, gx = cfg.grid
    ch = cfg.channels
    dev = x.device
    onscreen = ((x > -(A + 1.0)) & (x < W + A + 1.0)
                & (y > -(A + 1.0)) & (y < H + A + 1.0))
    sel = torch.nonzero(live & onscreen).squeeze(1)
    img = torch.zeros((H * W, ch), dtype=torch.float32, device=dev)
    if sel.numel() == 0:
        return img.reshape(H, W, ch), dict(dropped=0)
    x, y, rgb = x[sel], y[sel], color[sel, :ch]
    radius = torch.clamp(size[sel] * 0.5, 0.5, A + 0.5)
    k = int(math.ceil(_support(cfg.kernel, float(torch.amax(radius))))) + 1
    offsets = torch.arange(-k, k + 1, device=dev)

    def axis(p, g, extent):
        """Footprint pixels of each particle along one axis, their
        coverage, and whether each lies in the particle's tile window
        (its tile by truncation, like the JAX int cast) and the image."""
        t = torch.clamp((p / T).to(torch.int64), 0, g - 1)
        lo = torch.clamp(t * T - A, min=0)
        hi = torch.clamp(t * T + T + A, max=extent)
        pix = torch.floor(p).to(torch.int64)[:, None] + offsets  # (n, 2k+1)
        w = _profile(cfg.kernel, pix.to(torch.float32) + 0.5 - p[:, None],
                     radius[:, None])
        inside = (pix >= lo[:, None]) & (pix < hi[:, None])
        # Taps outside add 0 to a clamped in-image pixel.
        return (torch.clamp(pix, 0, extent - 1),
                torch.where(inside, w, 0.0))

    px, wx = axis(x, gx, W)
    py, wy = axis(y, gy, H)
    for j in range(offsets.shape[0]):
        w = wy[:, j:j + 1] * wx                                # (n, 2k+1)
        idx = py[:, j:j + 1] * W + px
        img.index_add_(0, idx.reshape(-1),
                       (w[..., None] * rgb[:, None, :]).reshape(-1, ch))
    return img.reshape(H, W, ch), dict(dropped=0)
