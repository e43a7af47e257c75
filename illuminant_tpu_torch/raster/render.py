"""ParticleSystem.Render: the user-facing particle draw (counterpart of
illuminant_tpu/raster/render.py).

ParticleAppearance (ParticleConfiguration.cs:42-109) picks how a system's
particles are drawn, over the routes of the JAX package:
  * no texture, additive: the direct splat of raster/tiled.py (the quad,
    the rounded disc, the Gaussian glow, or an explicit `kernel`);
  * no texture, `additive_blend=False`: the ordered alpha compositor
    (`tiled.rasterize_tiled_alpha`, K11a), with `dithered_opacity`;
  * a texture: the SVD sprite tables of raster/sprites.py, additive (K11b)
    or ordered alpha (K11a), with the sprite-sheet frame from
    AnimationRate / Row- / ColumnFromVelocity and RelativeSize;
  * `rounded` with `rounding_power_from_life`: a procedural power-disc
    table whose frame is the evaluated power bezier.
The tables are built once per appearance on the host and moved once to
each device that renders them; `z_formula` orders the alpha routes
back to front. The alpha routes read nothing back from the device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.bezier import ClampedBezier, constant_bezier, evaluate_bezier
from ..ops.coords import stipple_keep
from ..particles.state import ParticleState
from . import sprites as sprites_mod
from .tiled import (KERNEL_GAUSS, KERNEL_QUAD, KERNEL_ROUND,
                    TiledRasterConfig, rasterize_tiled,
                    rasterize_tiled_alpha)


@dataclasses.dataclass
class ParticleAppearance:
    """ParticleAppearance (ParticleConfiguration.cs:42-109): the JAX
    package's fields. Untextured particles draw as quads; `rounded` picks
    the disc, `glow` the Gaussian, an explicit `kernel` (tiled.KERNEL_*:
    point, quad, gauss, round) wins over both. A texture (TH, TW[, C])
    draws through an SVD sprite table of `rank`, `angle_bins` and
    `size_bins` over [size_min, size_max]; `rounding_power_from_life` (a
    float, or a bezier with a `.packed()` or already packed) animates a
    rounded disc's power with life through a table of `power_bins`
    powers."""

    texture: Optional[np.ndarray] = None  # (TH, TW[, C])
    columns: int = 1  # sprite sheet layout
    rows: int = 1
    animation_rate: Tuple[float, float] = (0.0, 0.0)
    rounded: bool = False
    glow: bool = False
    dithered_opacity: bool = False
    relative_size: bool = False
    row_from_velocity: bool = False
    column_from_velocity: bool = False
    size_min: float = 2.0
    size_max: float = 12.0
    angle_bins: int = 8
    size_bins: int = 4
    rank: int = 4
    kernel: Optional[str] = None
    rounding_power_from_life: object = None
    power_bins: int = 8

    # Caches: (key, host table, {device: table}); the power curve by the
    # identity of `rounding_power_from_life`.
    _table: object = dataclasses.field(default=None, repr=False)
    _ptable: object = dataclasses.field(default=None, repr=False)
    _pcurve: object = dataclasses.field(default=None, repr=False)

    @staticmethod
    def _cached(slot, key, build, device):
        if slot is None or slot[0] != key:
            slot = (key, build(), {})
        on = slot[2]
        dev = torch.device(device)
        if dev not in on:
            on[dev] = slot[1].to(dev)
        return slot, on[dev]

    def sprite_table(self, device="cuda"):
        """The texture's SpriteTable on `device`, or None without a
        texture. Keyed on the table-identity fields, as in the JAX package:
        a new texture, layout or bin count rebuilds it."""
        if self.texture is None:
            return None
        key = (id(self.texture), self.columns, self.rows, self.angle_bins,
               self.size_bins, self.rank, self.size_min, self.size_max)
        self._table, table = self._cached(
            self._table, key, lambda: sprites_mod.build_sprite_table(
                self.texture, frames_x=self.columns, frames_y=self.rows,
                angle_bins=max(self.angle_bins, 1),
                size_bins=max(self.size_bins, 1), rank=self.rank,
                size_min=self.size_min, size_max=self.size_max,
                device="cpu"), device)
        return table

    def _power_curve(self, device="cuda"):
        """rounding_power_from_life -> (ClampedBezier on `device` or None,
        (lo, hi) power range). A bezier's control points are read once
        per object (a read from the card if it lies there)."""
        rp = self.rounding_power_from_life
        if rp is None:
            return None, (1.0, 1.0)
        if isinstance(rp, (int, float)):
            return (constant_bezier([float(rp)], device=device),
                    (float(rp), float(rp)))
        if self._pcurve is None or self._pcurve[0] is not rp:
            packed = rp if isinstance(rp, ClampedBezier) else rp.packed()
            count = int(packed.range_and_count[2])
            ctrl = packed.points.cpu().numpy()[:max(count, 1), 0]
            self._pcurve = (rp, packed, (float(ctrl.min()),
                                         float(ctrl.max())))
        packed = self._pcurve[1]
        curve = packed.replace(
            range_and_count=packed.range_and_count.to(device),
            points=packed.points.to(device))
        return curve, self._pcurve[2]

    def power_disc_table(self, device="cuda"):
        """(SpriteTable on `device`, powers) of the RoundingPowerFromLife
        path, cached like sprite_table; `powers` is the host bin grid the
        per-particle frame selects into."""
        _, (lo, hi) = self._power_curve(device)
        lo = min(max(lo, 0.01), 1.0)
        hi = min(max(hi, 0.01), 1.0)
        bins = 1 if hi - lo < 1e-6 else max(self.power_bins, 2)
        powers = tuple(float(p) for p in np.linspace(lo, hi, bins))
        key = (powers, self.size_bins, self.rank, self.size_min,
               self.size_max)
        self._ptable, table = self._cached(
            self._ptable, key, lambda: sprites_mod.build_power_disc_table(
                powers, size_min=self.size_min, size_max=self.size_max,
                size_bins=max(self.size_bins, 1), rank=self.rank,
                device="cpu"), device)
        return table, powers


def _on(value, device):
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(value, np.float32), device=device)


def render_particles(state: ParticleState, config: TiledRasterConfig,
                     appearance: Optional[ParticleAppearance] = None,
                     additive_blend: bool = True, global_color=None,
                     stipple_factor: float = 1.0, z_to_y: float = 0.0,
                     size_scale: float = 1.0, background=None,
                     z_formula=None, size_from_z: float = 0.0):
    """Render a particle system's live slots -> ((H, W, C) image, diag)
    (render.py:146-303).

    Screen y = y - z * z_to_y; colors times `global_color`; sizes times
    `size_scale` and max(0, 1 + z * size_from_z) (fx:86); a
    `stipple_factor` below 1 keeps that golden-ratio fraction of the slots
    (fx:101-110, phase `config.stipple_offset`). `background` is added
    under an additive image and composited under an alpha one.
    `z_formula` (4 floats): screen_z = dot(z_formula, (x, y, z, 1)) orders
    the alpha routes back to front (a stable sort: ties keep slot order);
    additive blending is order-invariant, so it does nothing there."""
    app = appearance or ParticleAppearance()
    dev = state.position.device
    pos = state.position
    x = pos[:, 0]
    y = pos[:, 1] - pos[:, 2] * z_to_y
    color = state.render_color
    if global_color is not None:
        color = color * _on(global_color, dev)
    size = state.render_data[:, 0] * size_scale
    if not (isinstance(size_from_z, (int, float)) and size_from_z == 0.0):
        size = size * torch.clamp(1.0 + pos[:, 2] * size_from_z, min=0.0)
    live = state.live_mask()

    table = app.sprite_table(dev)
    power_path = (table is None and app.rounded
                  and app.rounding_power_from_life is not None)
    powers = None
    if power_path:
        table, powers = app.power_disc_table(dev)

    if not (isinstance(stipple_factor, (int, float))
            and stipple_factor >= 1.0):
        live = live & stipple_keep(state.capacity, stipple_factor,
                                   config.stipple_offset, device=dev)

    order = None
    if z_formula is not None and not additive_blend:
        zf = [float(v) for v in z_formula]
        screen_z = pos[:, 0] * zf[0] + pos[:, 1] * zf[1] \
            + pos[:, 2] * zf[2] + zf[3]
        order = torch.argsort(
            -torch.where(live, screen_z, -float("inf")), stable=True)
        x, y, color, size, live = (x[order], y[order], color[order],
                                   size[order], live[order])
    if background is not None:
        background = _on(background, dev)

    if table is not None:
        if app.relative_size and not power_path:
            # Size in texture-frame units; the tiled footprint is square,
            # so a non-square frame takes its larger side.
            tex = np.asarray(app.texture)
            fh = tex.shape[0] // max(app.rows, 1)
            fw = tex.shape[1] // max(app.columns, 1)
            size = size * max(max(fh, fw), 1)
        if power_path:
            # The frame is the nearest power bin of the evaluated
            # RoundingPowerFromLife bezier (fx:139 evaluates it at life);
            # a disc needs no rotation.
            curve, _ = app._power_curve(dev)
            p = evaluate_bezier(curve, pos[:, 3])[..., 0]
            if len(powers) > 1:
                span = powers[-1] - powers[0]
                frame = torch.round(
                    (torch.clamp(p, powers[0], powers[-1]) - powers[0])
                    / span * (len(powers) - 1))
            else:
                frame = torch.zeros_like(p)
            rotation = torch.zeros_like(frame)
        else:
            rotation = state.render_data[:, 1]
            frame = sprites_mod.animation_frame(
                table, pos[:, 3], state.velocity,
                animation_rate=app.animation_rate,
                row_from_velocity=app.row_from_velocity,
                column_from_velocity=app.column_from_velocity,
                frames_x=app.columns).to(torch.float32)
        if order is not None:
            rotation, frame = rotation[order], frame[order]
        if additive_blend:
            img, diag = sprites_mod.rasterize_sprites(
                config, table, x, y, color, size, live, rotation=rotation,
                frame=frame)
            if background is not None:
                img = img + background[..., :img.shape[-1]]
            return img, diag
        return sprites_mod.rasterize_sprites_alpha(
            config, table, x, y, color, size, live, rotation=rotation,
            frame=frame, background=background,
            dither=app.dithered_opacity)

    kernel = app.kernel or (KERNEL_GAUSS if app.glow
                            else KERNEL_ROUND if app.rounded else KERNEL_QUAD)
    if config.kernel != kernel:
        config = dataclasses.replace(config, kernel=kernel)
    if additive_blend:
        # dithered_opacity applies to the alpha routes only.
        img, diag = rasterize_tiled(config, x, y, color, size, live)
        if background is not None:
            img = img + background[..., :img.shape[-1]]
        return img, diag
    return rasterize_tiled_alpha(config, x, y, color, size, live,
                                 background=background,
                                 dither=app.dithered_opacity)
