"""Windowed (bounded) light evaluation.

Counterpart of illuminant_tpu/lighting/windowed.py. The reference never
shades a light over the whole screen: every light draws as an instanced
quad covering its bounds (LightingRenderer.cs:1149-1166). Here a
fixed-size window of the G-buffer is cut around the light
(`GBuffer.window`), the family core runs on the window, and the result is
added back at the origin. Light centers are host values (scene
constants), so origins are Python ints and the cuts are plain slices; the
JAX package's traced-origin path has no counterpart.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _corner(center, extent: int) -> float:
    """center - extent / 2, rounded to float32 and then half to even."""
    c = float(center.item() if torch.is_tensor(center) else center)
    return float(np.rint(np.float32(c - extent * 0.5)))


def window_origin(center_xy_px, win_h: int, win_w: int, height: int,
                  width: int):
    """(oy, ox) Python ints of a (win_h, win_w) window centered at
    `center_xy_px` (pixels; floats or a (2,) tensor, read on the host),
    clamped into the frame. The corner is rounded to float32 and then
    half to even, as `jnp.round` rounds it in the JAX package."""
    ox = int(min(max(_corner(center_xy_px[0], win_w), 0),
                 max(width - win_w, 0)))
    oy = int(min(max(_corner(center_xy_px[1], win_h), 0),
                 max(height - win_h, 0)))
    return oy, ox


def add_window(lightmap, contrib, oy: int, ox: int):
    """A copy of lightmap with [oy:oy+wh, ox:ox+ww, :C] += contrib, the
    contribution's channels cut or zero-padded to the lightmap's."""
    wh, ww, c = contrib.shape
    cl = lightmap.shape[-1]
    out = lightmap.clone()
    out[oy:oy + wh, ox:ox + ww, :min(c, cl)] += contrib[..., :cl]
    return out


def window_deficit_px(support_px, win: int):
    """How many pixels of a light's support the window cannot contain:
    max(0, ceil(2 * support) - win), int32; 0 means the window bounds the
    light. The reference never truncates: each light's quad is sized from
    its own bounds (LightingRenderer.cs:1193-1446)."""
    support_px = torch.as_tensor(support_px, dtype=torch.float32)
    return torch.clamp(torch.ceil(2.0 * support_px) - win,
                       min=0.0).to(torch.int32)


def window_for_support(support_px: float, height: int, width: int,
                       multiple: int = 16) -> int:
    """The smallest window (a multiple of `multiple`) containing a light
    of `support_px` support radius, clamped to the frame."""
    win = int(math.ceil(2.0 * float(support_px) / multiple)) * multiple
    return max(multiple, min(win, max(height, width)))


def accumulate_windowed(lightmap, gbuffer, centers_px, win: int,
                        accum_window, support_px=None):
    """Per-light bounded accumulation.

    centers_px: (L, 2) pixel centers (a tensor or nested floats; read on
    the host once). `accum_window(i, gb_win)` -> the (win, win, C)
    contribution of light i over its window. With `support_px` ((L,)
    support radii in pixels) returns (lightmap, deficit), the worst
    per-light truncation in pixels."""
    h, w = gbuffer.shape
    win_h = min(win, h)
    win_w = min(win, w)
    if torch.is_tensor(centers_px):
        centers_px = centers_px.detach().cpu().numpy()
    for i, center in enumerate(centers_px):
        oy, ox = window_origin(center, win_h, win_w, h, w)
        gb_win = gbuffer.window(oy, ox, win_h, win_w)
        contrib = accum_window(i, gb_win)
        lightmap = add_window(lightmap, contrib.to(lightmap.dtype), oy, ox)
    if support_px is not None:
        deficit = torch.max(window_deficit_px(support_px,
                                              min(win_h, win_w)))
        return lightmap, deficit
    return lightmap
