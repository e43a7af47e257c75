"""Distance-field visualisation: the editor's SDF debug raymarcher, and
host-side plots of a histogram and a bezier.

Counterpart of illuminant_tpu/utils/visualize.py (LightingRenderer.cs
VisualizeDistanceField :1699-1892, VisualizeCommon.fxh traceSurface /
traceOutlines, Histogram.cs:250-345, VisualizeBezier.fx). Orthographic
rays march the scene's distance field and hits are shaded as surfaces
(n.l) or as distance outlines. The march runs until no ray is live, as
the JAX package's while_loop does (one host read a step); `max_steps` is
accepted and unused there too.
"""

from __future__ import annotations

import numpy as np
import torch

from ..sdf.analytic import scene_normal, scene_sample

# VisualizeCommon.fxh:1-7.
SMALL_STEP_FACTOR = 1.0
EPSILON = 0.5
OUTLINE_SIZE = 1.8

VIS_SURFACES = 0
VIS_OUTLINES = 1


def _unit(v, device):
    v = torch.tensor(v, dtype=torch.float32, device=device)
    return v / torch.sqrt(torch.clamp(torch.sum(v * v), min=1e-12))


def visualize_distance_field(field, height: int, width: int,
                             mode: int = VIS_SURFACES,
                             ray_direction=(0.0, 0.0, -1.0),
                             start_z: float = 128.0, max_steps: int = 64,
                             light_direction=(-0.35, -0.35, -0.87),
                             device="cuda"):
    """-> (H, W, 4) visualisation image on `device` (the field's).

    Orthographic rays from z = start_z along ray_direction. Surfaces mode
    shades hits with a simple n.l; outlines mode draws distance isolines
    of the ground plane."""
    f32 = torch.float32
    ys = torch.arange(height, dtype=f32, device=device) + 0.5
    xs = torch.arange(width, dtype=f32, device=device) + 0.5
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    origin = torch.stack([gx, gy, torch.full_like(gx, start_z)], dim=-1)
    d = _unit(ray_direction, device)

    t = torch.zeros((height, width), dtype=f32, device=device)
    hit = torch.zeros((height, width), dtype=torch.bool, device=device)
    live = torch.ones((height, width), dtype=torch.bool, device=device)
    while bool(live.any()):
        dist = scene_sample(field, origin + d * t[..., None])
        new_hit = dist <= EPSILON
        step = torch.clamp(torch.abs(dist) * SMALL_STEP_FACTOR, min=0.5)
        t = torch.where(live & ~new_hit, t + step, t)
        below = (origin[..., 2] + d[2] * t) < -1.0
        live = live & ~new_hit & ~below & (t < 4096.0)
        hit = hit | new_hit

    pos = origin + d * t[..., None]
    if mode == VIS_SURFACES:
        n = scene_normal(field, pos)
        l = _unit(light_direction, device)
        diffuse = torch.clamp(torch.sum(n * -l, dim=-1), 0.0, 1.0)
        shade = 0.2 + 0.8 * diffuse
        rgb = torch.stack([shade, shade * 0.95, shade * 0.9], dim=-1)
        rgb = torch.where(hit[..., None], rgb, 0.0)
    else:
        # Rings of the 2D distance at the ground plane.
        ground = torch.cat([origin[..., :2],
                            torch.zeros_like(origin[..., :1])], dim=-1)
        dist = scene_sample(field, ground)
        ring = torch.abs(torch.remainder(dist, 16.0) - 8.0) < OUTLINE_SIZE
        surface = torch.abs(dist) < OUTLINE_SIZE
        rgb = torch.stack([surface.to(f32), ring.to(f32) * 0.5,
                           torch.where(dist < 0.0, 0.35, 0.0)], dim=-1)
    return torch.cat([rgb, torch.ones_like(rgb[..., :1])], dim=-1)


def _host(v):
    return np.asarray(torch.as_tensor(v).detach().cpu(), np.float64)


def draw_histogram(result, width: int = 256, height: int = 96,
                   percentiles=(), range_min=None, range_max=None,
                   max_input_value: float = 64.0,
                   sample_count_power: float = 2.0):
    """HistogramVisualizer.Draw (Histogram.cs:250-345), host-side numpy.

    Bars span each bucket's value range on a linear x axis; a bar's height
    is the mean of the linear and log-scaled counts (:281-287); colours
    ramp black -> white -> yellow -> red by bucket value; percentile and
    median markers are vertical lines; the tonemap range is a dim band.
    Returns (height, width, 4) float32 RGBA."""
    from .histogram import percentile as pct

    counts = _host(result.counts)
    bounds = _host(result.boundaries)
    img = np.zeros((height, width, 4), np.float32)
    img[:] = np.asarray([0.098, 0.098, 0.439, 0.75], np.float32)  # bg

    value_colors = np.asarray(
        [[0, 0, 0], [1, 1, 1], [1, 1, 0], [1, 0, 0]], np.float32)
    total = max(counts.sum(), 1.0)
    log_max = np.log(total + 1.0) / np.log(sample_count_power)

    if range_min is not None or range_max is not None:
        lo = 0.0 if range_min is None else range_min
        hi = max_input_value if range_max is None else range_max
        x1 = int(np.clip(lo / max_input_value, 0, 1) * (width - 1))
        x2 = int(np.clip(hi / max_input_value, 0, 1) * (width - 1))
        img[:, x1:x2 + 1, :3] += 0.15

    start = 0.0
    for i, c in enumerate(counts):
        end = bounds[i]
        x1 = int(np.clip(start / max_input_value, 0, 1) * (width - 1))
        x2 = max(x1 + 1, int(np.clip(end / max_input_value, 0, 1)
                             * (width - 1)))
        scaled = c / total
        scaled_log = (np.log(c + 1.0) / np.log(sample_count_power)
                      / max(log_max, 1e-9))
        bar = (scaled + scaled_log) * 0.5
        y1 = int(round((1.0 - bar) * (height - 1)))
        value = (start + end) / 2.0
        lo_i = int(np.clip(np.floor(value), 0, len(value_colors) - 1))
        hi_i = min(lo_i + 1, len(value_colors) - 1)
        t = float(np.clip(value - np.floor(value), 0, 1))
        color = value_colors[lo_i] * (1 - t) + value_colors[hi_i] * t
        img[y1:, x1:x2, :3] = color
        img[y1:, x1:x2, 3] = 1.0
        start = end

    def vline(value, color):
        x = int(np.clip(value / max_input_value, 0, 1) * (width - 1))
        img[:, x, :3] = color
        img[:, x, 3] = 1.0

    for p in percentiles:
        vline(float(pct(result, p)), np.asarray([1, 1, 1], np.float32))
    vline(float(pct(result, 50.0)),
          np.asarray([0.0, 1.0, 0.5], np.float32))  # median, SpringGreen

    img[0, :, :] = [1, 1, 1, 1]
    img[-1, :, :] = [1, 1, 1, 1]
    img[:, 0, :] = [1, 1, 1, 1]
    img[:, -1, :] = [1, 1, 1, 1]
    return img


def visualize_bezier(bezier, width: int = 256, height: int = 128,
                     x_min: float = 0.0, x_max: float = 1.0):
    """VisualizeBezier.fx: each channel's curve over [x_min, x_max] ->
    (height, width, 4) float32 RGBA (channel colours r / g / b / white),
    host-side numpy."""
    from ..ops.bezier import evaluate_bezier

    xs = np.linspace(x_min, x_max, width, dtype=np.float32)
    ys = evaluate_bezier(bezier, xs).cpu().numpy()  # (W, C)
    lo = float(ys.min())
    hi = float(ys.max())
    span = max(hi - lo, 1e-6)
    img = np.zeros((height, width, 4), np.float32)
    img[..., 3] = 1.0
    chan_colors = np.asarray(
        [[1, 0.3, 0.3], [0.3, 1, 0.3], [0.4, 0.5, 1], [1, 1, 1]], np.float32)
    for c in range(ys.shape[1]):
        yy = np.clip(((hi - ys[:, c]) / span * (height - 1)).astype(np.int64),
                     0, height - 1)
        img[yy, np.arange(width), :3] = chan_colors[c % 4]
    return img
