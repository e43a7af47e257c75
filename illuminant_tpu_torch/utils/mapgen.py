"""Map-generation tooling (the GenerateMaps editor scene).

Counterpart of illuminant_tpu/utils/mapgen.py: `normals_from_lightmaps`
(ProcessNormals.fx NormalsFromLightmaps: four lightmaps lit from the
left, right, above and below become a tangent-space normal map, with the
input window and dead-pixel detection, :52-100) and the ProcessHeightmap
family (heightmap -> normals or displacement, distance -> height).
Elementwise PyTorch on the inputs' device.
"""

from __future__ import annotations

import torch


def _clean_input(value, input_min, input_max, shadows_only):
    result = (value - input_min) / max(input_max - input_min, 1e-6)
    if shadows_only:
        result = result - 0.5
    return torch.clamp(result, 0.0, 1.0)


def normals_from_lightmaps(left, right, above, below,
                           input_min: float = 0.0, input_max: float = 1.0,
                           forward_scale: float = 1.0,
                           forward_bias: float = 0.0,
                           shadows_only: bool = False):
    """Four (H, W) luminance lightmaps -> (H, W, 4) encoded normal map.
    Dead pixels (all four inputs dark, ProcessNormals.fx:94-97) encode as
    (0, 0, 0, 1), the rest as normal * 0.5 + 0.5 (:156-159)."""
    l = _clean_input(left, input_min, input_max, shadows_only)
    r = _clean_input(right, input_min, input_max, shadows_only)
    a = _clean_input(above, input_min, input_max, shadows_only)
    b = _clean_input(below, input_min, input_max, shadows_only)

    x_delta = r - l
    y_delta = b - a
    xy_len = torch.sqrt(x_delta * x_delta + y_delta * y_delta)
    forward = torch.where(
        xy_len <= 0.01, 1.0,
        torch.where(xy_len >= 0.98, 0.0,
                    torch.sqrt(torch.clamp(1.0 - xy_len, min=0.0)))) \
        * forward_scale

    n = torch.stack([x_delta, y_delta, forward + forward_bias], dim=-1)
    n = n / torch.sqrt(torch.clamp(torch.sum(n * n, dim=-1, keepdim=True),
                                   min=1e-12))
    dead = (l <= 0.01) & (r <= 0.01) & (a <= 0.01) & (b <= 0.01)
    encoded = torch.where(dead[..., None], 0.0, n * 0.5 + 0.5)
    return torch.cat([encoded, torch.ones_like(encoded[..., :1])], dim=-1)


# --- ProcessHeightmap.fx / ProcessHeightmap.fxh ---------------------------


def _synthesize_alpha(value):
    """ProcessHeightmap.fxh synthesizeAlpha: smoothstep band on |value|."""
    a = torch.abs(value)
    t = torch.clamp((a - 0.01) / (0.15 - 0.01), 0.0, 1.0)
    s = t * t * (3.0 - 2.0 * t)
    return torch.where(a < 0.01, 0.0, s)


def _shift(img, dy, dx):
    """Clamped-edge neighbour tap (the reference samples with CLAMP)."""
    h, w = img.shape
    ys = torch.clamp(torch.arange(h, device=img.device) + dy, 0, h - 1)
    xs = torch.clamp(torch.arange(w, device=img.device) + dx, 0, w - 1)
    return img[ys][:, xs]


def heightmap_to_normals(heightmap, normals_are_signed: bool = False,
                         normal_elevation_clamping: bool = False):
    """ProcessHeightmap.fx HeightmapToNormals (+ calculateNormal,
    ProcessHeightmap.fxh:30-88): central differences of the heightmap with
    elevation clamping and the synthesized-alpha mask -> (H, W, 4)."""
    center = heightmap
    a = _shift(heightmap, 0, -1)
    b = _shift(heightmap, 0, 1)
    c = _shift(heightmap, -1, 0)
    d = _shift(heightmap, 1, 0)

    alpha = torch.maximum(
        _synthesize_alpha(center),
        torch.maximum(
            torch.maximum(_synthesize_alpha(a), _synthesize_alpha(b)),
            torch.maximum(_synthesize_alpha(c), _synthesize_alpha(d))))
    if normal_elevation_clamping:
        a = torch.minimum(a, center)
        b = torch.minimum(b, center)
        c = torch.minimum(c, center)
        d = torch.minimum(d, center)

    eps = 0.001
    all_flat = ((torch.abs(center) < eps) & (torch.abs(a) < eps)
                & (torch.abs(b) < eps) & (torch.abs(c) < eps)
                & (torch.abs(d) < eps))
    alpha = torch.where(all_flat, 0.0, alpha)

    n = torch.stack([a - b, c - d, torch.full_like(center, 0.5)], dim=-1)
    n = n / torch.sqrt(torch.clamp(torch.sum(n * n, dim=-1, keepdim=True),
                                   min=1e-12))
    encoded = n if normals_are_signed else n * 0.5 + 0.5
    return torch.cat([encoded, alpha[..., None]], dim=-1)


def heightmap_to_displacement(heightmap, displacement_scale=(1.0, 1.0),
                              normal_elevation_clamping: bool = False):
    """ProcessHeightmap.fx HeightmapToDisplacement: normal.xy scaled into
    a 0.5-biased displacement map (H, W, 4)."""
    n = heightmap_to_normals(
        heightmap, normals_are_signed=True,
        normal_elevation_clamping=normal_elevation_clamping)
    dx = n[..., 0] * displacement_scale[0] + 0.5
    dy = n[..., 1] * displacement_scale[1] + 0.5
    return torch.stack([dx, dy, torch.full_like(dx, 0.5),
                        torch.ones_like(dx)], dim=-1)


def height_from_distance(distance, min_distance: float = 0.0,
                         max_distance: float = 32.0,
                         min_height: float = 0.0, max_height: float = 1.0,
                         distance_power_1: float = 1.0,
                         distance_power_2: float = 1.0):
    """ProcessHeightmap.fx HeightFromDistance: a (jump-flood) distance
    image -> heightmap. Pixels beyond max_distance write 0 (the discard);
    the interior is higher, so height runs max -> min as the distance
    grows (:20-43)."""
    d = torch.clamp(distance, min=min_distance)
    outside = d > max_distance
    t = (d - min_distance) / max(max_distance - min_distance, 1e-6)
    t = 1.0 - torch.pow(
        1.0 - torch.clamp(torch.pow(torch.clamp(t, 0.0, 1.0),
                                    distance_power_1), 0.0, 1.0),
        distance_power_2)
    h = max_height + (min_height - max_height) * t
    h = torch.where(outside, 0.0, h)
    one = torch.where(outside, 0.0, 1.0)
    return torch.stack([h, h, h, one], dim=-1)
