"""Particle rasterization by screen tile (counterpart of
illuminant_tpu/raster/tiled.py: `rasterize_tiled`, `bin_particles`,
`composite_over_tiles`, `rasterize_tiled_alpha`).

The JAX package bins particles by 32-px screen tile with a sort, slices
fixed-capacity bins, and splats each tile's separable coverage as one-hot
matmuls on the MXU, overlap-adding tile windows that reach `apron` pixels
past their tile. The port computes the same additive image as a direct
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

The ordered alpha route keeps the JAX package's binning: every live
on-screen particle is listed in each tile that its support box touches
(`bin_footprints`, the rule of `bin_particles(replicate_footprint=True)`),
the lists stable-sorted by tile so that each keeps draw order, and each
tile composites its own pixels over its list in that order
(`composite_over_tiles`, the CUDA kernel K11a of `tile_kernel.py`). The
bins are unbounded: nothing is dropped and `dropped` is 0.
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


def bin_footprints(cfg: TiledRasterConfig, x, y, live, support_size=None):
    """Screen-tile bins of the live on-screen particles, in draw order
    (bin_particles, tiled.py:269-434, without its capacity):
    -> (ids (M,) int32 particle indices grouped by tile, starts (NT + 1,)
    int32), tile t's particles being ids[starts[t]:starts[t + 1]] in
    index order. Dead and off-screen particles are keyed past the last
    tile (`starts[NT]` ends the live entries); nothing is read back.

    `support_size` None: each particle in its own tile (the additive
    sprite path). Otherwise (N,) the size the support box is made from:
    the particle is listed in every tile, up to 2 x 2, that the box of
    half-width clip(support_size / 2, 0.5, apron + 0.5) + 0.5 touches
    (`replicate_footprint`, tiled.py:301-334). Tile indices truncate
    toward zero, as the JAX int cast does, and are clipped to the grid.
    A profile's tail past that box (a Gaussian's reaches 2r) is cut at
    the tile border there too."""
    gy, gx = cfg.grid
    nt = gy * gx
    a, t = cfg.apron, cfg.tile
    ok = live & ((x > -(a + 1.0)) & (x < cfg.width + a + 1.0)
                 & (y > -(a + 1.0)) & (y < cfg.height + a + 1.0))
    sentinel = torch.full_like(x, nt, dtype=torch.int32)

    def tile(p, g):
        return torch.clamp((p / t).to(torch.int32), 0, g - 1)

    if support_size is None:
        key = torch.where(ok, tile(y, gy) * gx + tile(x, gx), sentinel)
        rep = 1
    else:
        r_sup = torch.clamp(support_size * 0.5, 0.5, a + 0.5) + 0.5
        txa, txb = tile(x - r_sup, gx), tile(x + r_sup, gx)
        tya, tyb = tile(y - r_sup, gy), tile(y + r_sup, gy)
        keys = []
        for cy, cx in ((0, 0), (0, 1), (1, 0), (1, 1)):
            k_ok = ok
            if cx:
                k_ok = k_ok & (txb > txa)
            if cy:
                k_ok = k_ok & (tyb > tya)
            keys.append(torch.where(k_ok, (tyb if cy else tya) * gx
                                    + (txb if cx else txa), sentinel))
        # Particle-major: the stable sort keeps index order in each tile.
        key = torch.stack(keys, dim=1).reshape(-1)
        rep = 4
    skey, perm = torch.sort(key, stable=True)
    starts = torch.searchsorted(
        skey, torch.arange(nt + 1, dtype=torch.int32, device=x.device))
    return ((perm // rep).to(torch.int32), starts.to(torch.int32))


def alpha_records(cfg: TiledRasterConfig, x, y, color, size, opacity=None):
    """(N, 8) float32 particle records of the ordered alpha route: x, y,
    the straight colour premult / max(a, 1e-6) (tiled.py:789-792), the
    effective alpha a * opacity, the profile radius clip(size / 2, 0.5,
    apron + 0.5) (tiled.py:538) and a spare 0. `color` (N, 4)
    premultiplied."""
    a = color[:, 3]
    straight = color[:, :3] / torch.clamp(a, min=1e-6)[:, None]
    a_op = a if opacity is None else a * opacity
    radius = torch.clamp(size * 0.5, 0.5, cfg.apron + 0.5)
    return torch.cat([x[:, None], y[:, None], straight, a_op[:, None],
                      radius[:, None], torch.zeros_like(x)[:, None]],
                     dim=1).contiguous()


def __getattr__(name):
    # `composite_over_tiles` is defined in tile_kernel.py, which imports
    # this module, so it is re-exported on first access.
    if name == "composite_over_tiles":
        from .tile_kernel import composite_over_tiles

        return composite_over_tiles
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def rasterize_tiled_alpha(cfg: TiledRasterConfig, x, y, color, size, live,
                          background=None, dither: bool = False,
                          opacity=None):
    """Ordered 'over' rasterization (tiled.py:825-860): particles
    composite in index order, tile by tile, with the profile
    `cfg.kernel`. `color` (N, 4) premultiplied; `opacity` (a float or a
    0-d tensor) scales every fragment's alpha. Returns ((H, W, 4)
    image, {"dropped": 0})."""
    if cfg.channels != 4:
        raise ValueError("alpha compositing needs the alpha channel: "
                         "channels must be 4")
    from . import tile_kernel

    bins = bin_footprints(cfg, x, y, live, support_size=size)
    img = tile_kernel.composite_over_tiles(
        cfg, bins, alpha_records(cfg, x, y, color, size, opacity),
        cfg.kernel, background, dither)
    return img, dict(dropped=0)
