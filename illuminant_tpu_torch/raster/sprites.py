"""Textured sprite rasterization through SVD-factored sprite tables
(counterpart of illuminant_tpu/raster/sprites.py).

The reference draws each particle as a textured quad with sprite-sheet
frame selection, rotation and sizing (RasterizeParticleSystem.fx:62-144;
the frame from AnimationRate / RowFromVelocity / ColumnFromVelocity,
ParticleConfiguration.cs:42-109). The JAX package factors every sprite
variant (frame x rotation bin x size bin) on the host into a rank-R
separable approximation by SVD,

    sprite_b(dy, dx) ~= sum_r row_b[r, dy] * col_b[r, dx],

and the port keeps those tables: they are built by the same numpy code and
equal the JAX tables bit for bit, so both packages draw the same function.
The quantization contract is the JAX package's: rotation to `angle_bins`,
size to `size_bins` log-spaced steps in [size_min, size_max], rank
truncation reported as `residual`.

A particle's coverage is each rank's row and column factor lerped at its
sub-pixel offset and summed over the ranks, inside the window of the tile
it is binned to. `rasterize_sprites` adds colour x coverage (the CUDA
kernel K11b, `tile_kernel.sprite_accumulate`); `rasterize_sprites_alpha`
composites in draw order with the coverage clipped to [0, 1] (K11a,
`tile_kernel.composite_over_tiles`). Neither drops a particle: `dropped`
is 0.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.pytree import tensor_dataclass
from . import tile_kernel
from .tiled import TiledRasterConfig, alpha_records, bin_footprints


@tensor_dataclass
class SpriteTable:
    """Factored sprite variants: row_factors / col_factors (B, R, S)
    float32, B = frames * angle_bins * size_bins, R the rank, S the
    (odd) support. Variant b covers an S x S pixel window centred on the
    particle."""

    row_factors: torch.Tensor
    col_factors: torch.Tensor
    frames: int = 1
    angle_bins: int = 1
    size_bins: int = 1
    size_min: float = 1.0
    size_max: float = 8.0
    residual: float = 0.0

    @property
    def rank(self) -> int:
        return self.row_factors.shape[1]

    @property
    def support(self) -> int:
        return self.row_factors.shape[2]

    def to(self, device) -> "SpriteTable":
        return self.replace(row_factors=self.row_factors.to(device),
                            col_factors=self.col_factors.to(device))


def _render_variant(tex: np.ndarray, angle: float, size: float,
                    support: int, oversample: int = 4) -> np.ndarray:
    """One sprite variant (rotated, scaled) on an S x S grid, box-filtered
    by supersampling (the quad edge antialiasing of the GPU rasterizer);
    the JAX package's host code (sprites.py:71-91)."""
    s = support
    os_ = oversample
    coords = (np.arange(s * os_) + 0.5) / os_ - s / 2.0
    dy, dx = np.meshgrid(coords, coords, indexing="ij")
    ca, sa = np.cos(-angle), np.sin(-angle)
    u = (dx * ca - dy * sa) / size + 0.5  # sprite-local [0, 1]
    v = (dx * sa + dy * ca) / size + 0.5
    th, tw = tex.shape[:2]
    inside = (u >= 0) & (u < 1) & (v >= 0) & (v < 1)
    ti = np.clip((v * th).astype(np.int64), 0, th - 1)
    tj = np.clip((u * tw).astype(np.int64), 0, tw - 1)
    val = tex[ti, tj] * inside
    val = val.reshape(s, os_, s, os_).mean(axis=(1, 3))
    return val.astype(np.float32)


def build_sprite_table(texture: np.ndarray, frames_x: int = 1,
                       frames_y: int = 1, angle_bins: int = 1,
                       size_bins: int = 4, rank: int = 3,
                       size_min: float = 2.0, size_max: float = 12.0,
                       support: Optional[int] = None,
                       device="cuda") -> SpriteTable:
    """Factor a sprite sheet into a SpriteTable by SVD on the host
    (sprites.py:94-159), then put it on `device`. `texture` (H, W) or
    (H, W, C): C > 1 takes the last channel as the sprite's intensity
    (the particle's colour modulates it). More than 256 variants raise
    ValueError, as in the JAX package (whose variant ids ride a bf16
    lane), so both packages accept the same tables."""
    tex = np.asarray(texture, np.float32)
    if tex.ndim == 3:
        tex = tex[..., -1]
    frames = frames_x * frames_y
    fh = tex.shape[0] // frames_y
    fw = tex.shape[1] // frames_x
    if support is None:
        support = int(np.ceil(size_max)) | 1  # odd
    s = support
    n_variants = frames * angle_bins * size_bins
    if n_variants > 256:
        raise ValueError(
            f"frames*angle_bins*size_bins = {n_variants} > 256: reduce the "
            "bins or split the sheet into several tables")
    sizes = np.exp(np.linspace(np.log(size_min), np.log(size_max),
                               size_bins))
    rows = np.zeros((n_variants, rank, s), np.float32)
    cols = np.zeros_like(rows)
    worst = 0.0
    b = 0
    for f in range(frames):
        fy, fx = divmod(f, frames_x)
        frame_tex = tex[fy * fh:(fy + 1) * fh, fx * fw:(fx + 1) * fw]
        for a in range(angle_bins):
            angle = 2.0 * np.pi * a / angle_bins
            for si in range(size_bins):
                variant = _render_variant(frame_tex, angle, sizes[si], s)
                u, sv, vt = np.linalg.svd(variant)
                r = min(rank, len(sv))
                scale = np.sqrt(sv[:r])
                rows[b, :r] = (u[:, :r] * scale).T
                cols[b, :r] = vt[:r] * scale[:, None]
                total = np.linalg.norm(sv)
                worst = max(worst, float(np.linalg.norm(sv[r:])
                                         / max(total, 1e-9)))
                b += 1
    return SpriteTable(
        row_factors=torch.as_tensor(rows, device=device),
        col_factors=torch.as_tensor(cols, device=device),
        frames=frames, angle_bins=angle_bins, size_bins=size_bins,
        size_min=float(size_min), size_max=float(size_max), residual=worst)


def circular_alpha(dist, power):
    """computeCircularAlpha (RasterizeParticleSystem.fx:144-156): `dist`
    the normalized quad-local distance (1 at the inscribed circle's
    edge), `power` the rounding power, clamped to [0.001, 1] and floored
    at 0.01 as the shaders do. NumPy or torch, after its arguments."""
    if isinstance(dist, torch.Tensor):
        p = torch.as_tensor(power, dtype=torch.float32, device=dist.device)
        p = torch.clamp(torch.clamp(p, 0.001, 1.0), min=0.01)
        divisor = torch.clamp(torch.clamp(1.0 - p, 0.0, 1.0), min=0.001)
        dfe = torch.clamp(dist - p, 0.0, 1.0) / divisor
        return torch.clamp(1.0 - dfe ** p, 0.0, 1.0)
    p = np.maximum(np.clip(power, 0.001, 1.0), 0.01)
    divisor = np.maximum(np.clip(1.0 - p, 0.0, 1.0), 0.001)
    dfe = np.clip(dist - p, 0.0, 1.0) / divisor
    return np.clip(1.0 - dfe ** p, 0.0, 1.0)


def build_power_disc_table(powers, size_min: float = 2.0,
                           size_max: float = 12.0, size_bins: int = 4,
                           rank: int = 3, support: Optional[int] = None,
                           cell: int = 128, device="cuda") -> SpriteTable:
    """Procedural rounded-disc table whose frame axis is the rounding
    power (RoundingPowerFromLife): frame i is the radial
    computeCircularAlpha profile at powers[i], box-filtered onto the
    variant grid like any sprite (sprites.py:175-202)."""
    frames = []
    coords = ((np.arange(cell) + 0.5) / cell) * 2.0 - 1.0
    dyy, dxx = np.meshgrid(coords, coords, indexing="ij")
    dist = np.sqrt(dxx * dxx + dyy * dyy)
    for p in powers:
        frames.append(circular_alpha(dist, float(p)).astype(np.float32))
    tex = np.concatenate(frames, axis=0)  # vertical frame stack
    return build_sprite_table(
        tex, frames_x=1, frames_y=len(frames), angle_bins=1,
        size_bins=size_bins, rank=rank, size_min=size_min,
        size_max=size_max, support=support, device=device)


def select_bins(table: SpriteTable, frame, angle, size):
    """Per-particle variant index (int32) from frame, rotation and size
    (sprites.py:205-222): rotation and log size round half to even, as
    jnp.round does; the angle bin wraps with a floored modulo."""
    fi = torch.clamp(frame.to(torch.int32), 0, table.frames - 1)
    ai = torch.remainder(
        torch.round(angle / (2.0 * math.pi) * table.angle_bins
                    ).to(torch.int32), table.angle_bins)
    logs = torch.log(torch.clamp(size, table.size_min, table.size_max)
                     / table.size_min)
    log_span = float(np.log(table.size_max / table.size_min))
    si = torch.clamp(
        torch.round(logs / max(log_span, 1e-9) * (table.size_bins - 1)
                    ).to(torch.int32), 0, table.size_bins - 1)
    return (fi * table.angle_bins + ai) * table.size_bins + si


def animation_frame(table: SpriteTable, life, velocity,
                    animation_rate: Tuple[float, float] = (0.0, 0.0),
                    row_from_velocity: bool = False,
                    column_from_velocity: bool = False, frames_x: int = 1):
    """Sprite-sheet frame (int32) from life and velocity
    (sprites.py:225-248, ParticleConfiguration.cs:42-109): AnimationRate
    advances the frame with life; Row/ColumnFromVelocity pick the row or
    column from the velocity's angle."""
    frames = table.frames
    frames_y = max(frames // max(frames_x, 1), 1)
    fx = torch.zeros_like(life)
    fy = torch.zeros_like(life)
    if animation_rate[0]:
        fx = torch.floor(life * animation_rate[0])
    if animation_rate[1]:
        fy = torch.floor(life * animation_rate[1])
    angle = torch.atan2(velocity[:, 1], velocity[:, 0])
    turns = torch.remainder(angle / (2.0 * math.pi) + 1.0, 1.0)
    if column_from_velocity:
        fx = torch.floor(turns * frames_x)
    if row_from_velocity:
        fy = torch.floor(turns * frames_y)
    return torch.remainder(fy * frames_x + fx, frames).to(torch.int32)


def _variants(cfg: TiledRasterConfig, table: SpriteTable, x, size,
              rotation, frame):
    half = table.support // 2
    if cfg.apron < half:
        raise ValueError(f"apron {cfg.apron} < the sprite support's "
                         f"half-width {half}")
    rot = rotation if rotation is not None else torch.zeros_like(x)
    frm = frame if frame is not None else torch.zeros_like(x)
    return select_bins(table, frm, rot, size).to(torch.float32)


def rasterize_sprites(cfg: TiledRasterConfig, table: SpriteTable, x, y,
                      color, size, live, rotation=None, frame=None):
    """Additive textured-sprite rasterization -> ((H, W, C) image,
    {"dropped": 0, "residual"}) with C = cfg.channels (sprites.py:
    344-379). Each live on-screen particle adds colour x coverage to the
    pixels of its own tile's window (the tile plus `apron`, which must be
    at least support // 2); `color` (N, >= C) premultiplied."""
    variant = _variants(cfg, table, x, size, rotation, frame)
    ch = cfg.channels
    col = color[:, :ch]
    if ch < 4:
        col = torch.cat([col, torch.zeros_like(x)[:, None].expand(
            -1, 4 - ch)], dim=1)
    records = torch.cat([x[:, None], y[:, None], col,
                         torch.zeros_like(x)[:, None], variant[:, None]],
                        dim=1).contiguous()
    bins = bin_footprints(cfg, x, y, live)
    img = tile_kernel.sprite_accumulate(
        cfg, bins, records, (table.row_factors, table.col_factors))
    return img, dict(dropped=0, residual=table.residual)


def rasterize_sprites_alpha(cfg: TiledRasterConfig, table: SpriteTable, x,
                            y, color, size, live, rotation=None, frame=None,
                            background=None, dither: bool = False):
    """Ordered 'over' compositing of textured sprites -> ((H, W, 4),
    {"dropped": 0, "residual"}) (sprites.py:382-426): each tile composites
    the sprites whose support box touches it, in draw order, with the
    rank-R coverage clipped to [0, 1] as the opacity modulation (texture
    alpha x particle alpha) and the particle's straight colour as the
    source; `dither` the Bayer discard. The support box's radius is
    min(size, 2 x support)."""
    if cfg.channels != 4:
        raise ValueError("alpha compositing needs 4 channels")
    variant = _variants(cfg, table, x, size, rotation, frame)
    records = alpha_records(cfg, x, y, color, size)
    records[:, 7] = variant
    bins = bin_footprints(cfg, x, y, live, support_size=torch.clamp(
        size, max=2.0 * table.support))
    img = tile_kernel.composite_over_tiles(
        cfg, bins, records, (table.row_factors, table.col_factors),
        background, dither)
    return img, dict(dropped=0, residual=table.residual)
