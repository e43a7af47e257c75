"""Exact scatter rasterization of particles (counterpart of
illuminant_tpu/raster/particles.py), the oracle of the splats.

Each live particle scatters its coverage into the image with
`index_add_`: `splat_additive` a bilinear 2x2 footprint,
`rasterize_additive` a (size x size) quad with circular rounding
(`computeCircularAlpha`, RasterizeParticleSystem.fx:145-156) over a static
`footprint`^2 fan, with stipple rejection (fx StippleReject), or the
exact computeCircularAlpha curve at a `rounding_power`. Screen y = world
y - z * z_to_y, as the rasterizer's vertex path projects it.
"""

from __future__ import annotations

import torch

from ..ops.coords import stipple_keep
from ..particles.state import ParticleState
from .sprites import circular_alpha


def _scatter(img, width, yi, xi, contrib):
    img.view(-1, img.shape[-1]).index_add_(0, (yi * width + xi).reshape(-1),
                                           contrib)


def _color(state: ParticleState, global_color):
    color = state.render_color
    if global_color is not None:
        color = color * torch.as_tensor(global_color, dtype=torch.float32,
                                        device=color.device)
    return color


def splat_additive(state: ParticleState, height: int, width: int,
                   z_to_y: float = 0.0, render_scale: float = 1.0,
                   global_color=None):
    """(N,) particles -> (H, W, 4) additive HDR image: a bilinear
    footprint of 2x2 texels per particle. Dead and off-screen particles
    add nothing."""
    pos = state.position
    live = state.live_mask()
    x = pos[:, 0] * render_scale
    y = (pos[:, 1] - pos[:, 2] * z_to_y) * render_scale
    color = _color(state, global_color)
    tx = x - 0.5
    ty = y - 0.5
    x0 = torch.floor(tx)
    y0 = torch.floor(ty)
    wx = tx - x0
    wy = ty - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    img = torch.zeros((height, width, 4), dtype=torch.float32,
                      device=pos.device)
    for dy, dx, w in ((0, 0, (1 - wx) * (1 - wy)), (0, 1, wx * (1 - wy)),
                      (1, 0, (1 - wx) * wy), (1, 1, wx * wy)):
        xi = x0i + dx
        yi = y0i + dy
        inside = live & (xi >= 0) & (xi < width) & (yi >= 0) & (yi < height)
        contrib = color * (w * inside.to(torch.float32))[:, None]
        _scatter(img, width, torch.clamp(yi, 0, height - 1),
                 torch.clamp(xi, 0, width - 1), contrib)
    return img


def rasterize_additive(state: ParticleState, height: int, width: int,
                       footprint: int = 5, z_to_y: float = 0.0,
                       render_scale: float = 1.0, global_color=None,
                       rounded: bool = True, stipple_factor: float = 1.0,
                       size_scale: float = 1.0, rounding_power=None):
    """Sized-particle additive rasterization: each live particle covers a
    (size x size) quad, sizes clamped to [1, footprint] (footprint odd),
    every covered texel adding color x coverage. `rounding_power`: the
    exact computeCircularAlpha curve at that power
    (`sprites.circular_alpha`); else `rounded` a soft disc edge
    (~computeCircularAlpha), or per-axis box coverage."""
    pos = state.position
    live = state.live_mask()
    if stipple_factor < 1.0:
        live = live & stipple_keep(state.capacity, stipple_factor,
                                   device=pos.device)
    x = pos[:, 0] * render_scale
    y = (pos[:, 1] - pos[:, 2] * z_to_y) * render_scale
    size = torch.clamp(state.render_data[:, 0] * size_scale * render_scale,
                       1.0, float(footprint))
    radius = size * 0.5
    color = _color(state, global_color)

    half = footprint // 2
    img = torch.zeros((height, width, 4), dtype=torch.float32,
                      device=pos.device)
    xc = torch.floor(x).to(torch.int64)
    yc = torch.floor(y).to(torch.int64)
    fx = x - (xc.to(torch.float32) + 0.5)
    fy = y - (yc.to(torch.float32) + 0.5)
    for dy in range(-half, half + 1):
        for dx in range(-half, half + 1):
            # Distance from the texel center to the particle center.
            ddx = dx - fx
            ddy = dy - fy
            if rounding_power is not None:
                r = torch.sqrt(ddx * ddx + ddy * ddy)
                cov = circular_alpha(r / torch.clamp(radius, min=1e-6),
                                     rounding_power)
            elif rounded:
                r = torch.sqrt(ddx * ddx + ddy * ddy)
                cov = torch.clamp(radius - r + 0.5, 0.0, 1.0)
            else:
                cov = (torch.clamp(radius - torch.abs(ddx) + 0.5, 0.0, 1.0)
                       * torch.clamp(radius - torch.abs(ddy) + 0.5, 0.0, 1.0))
            xi = xc + dx
            yi = yc + dy
            inside = (live & (xi >= 0) & (xi < width) & (yi >= 0)
                      & (yi < height) & (cov > 0.0))
            contrib = color * (cov * inside.to(torch.float32))[:, None]
            _scatter(img, width, torch.clamp(yi, 0, height - 1),
                     torch.clamp(xi, 0, width - 1),
                     torch.where(inside[:, None], contrib, 0.0))
    return img
