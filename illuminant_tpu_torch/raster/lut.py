"""3D colour LUT grading: a dark and a bright LUT blended by scene
brightness.

Counterpart of illuminant_tpu/raster/lut.py (LUTResolve.fx:60-115 and
LUTBlendingConfiguration, LightingRenderer.HDR.cs:260-273). LUTs are
(N, N, N, 3) arrays indexed [b][g][r]; the trilinear fetch is eight
gathers by plain tensor indexing. The configuration's levels are Python
floats and stay on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..ops.tonemap import RGB_TO_LUMINANCE


def identity_lut(size: int = 16) -> np.ndarray:
    r = np.linspace(0.0, 1.0, size, dtype=np.float32)
    b, g, rr = np.meshgrid(r, r, r, indexing="ij")
    return np.stack([rr, g, b], axis=-1)


def sample_lut(lut, rgb):
    """Trilinear (..., 3) lookup in an (N, N, N, 3) LUT tensor."""
    n = lut.shape[0]
    c = torch.clamp(rgb, 0.0, 1.0) * (n - 1)
    c0 = torch.floor(c)
    f = c - c0
    c0 = c0.to(torch.int64)
    c1 = torch.clamp(c0 + 1, 0, n - 1)

    def fetch(ri, gi, bi):
        return lut[bi, gi, ri]

    r0, g0, b0 = c0[..., 0], c0[..., 1], c0[..., 2]
    r1, g1, b1 = c1[..., 0], c1[..., 1], c1[..., 2]
    fr, fg, fb = f[..., 0:1], f[..., 1:2], f[..., 2:3]

    v000 = fetch(r0, g0, b0)
    v100 = fetch(r1, g0, b0)
    v010 = fetch(r0, g1, b0)
    v110 = fetch(r1, g1, b0)
    v001 = fetch(r0, g0, b1)
    v101 = fetch(r1, g0, b1)
    v011 = fetch(r0, g1, b1)
    v111 = fetch(r1, g1, b1)
    v00 = v000 + (v100 - v000) * fr
    v10 = v010 + (v110 - v010) * fr
    v01 = v001 + (v101 - v001) * fr
    v11 = v011 + (v111 - v011) * fr
    v0 = v00 + (v10 - v00) * fg
    v1 = v01 + (v11 - v01) * fg
    return v0 + (v1 - v0) * fb


@dataclasses.dataclass
class LUTBlendingConfiguration:
    dark_lut: Optional[np.ndarray] = None
    bright_lut: Optional[np.ndarray] = None
    per_channel: bool = False
    lut_only: bool = False
    dark_level: float = 0.0
    bright_level: float = 1.0
    neutral_band_size: float = 0.0


def lut_blended_resolve(albedo, lightmap, config: LUTBlendingConfiguration,
                        inverse_scale: float = 1.0):
    """(H, W, 4) albedo x lightmap -> graded (H, W, 4)
    (LUTResolve.fx:60-115). The LUTs are uploaded to the albedo's
    device."""
    dev = albedo.device

    def lut(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    dark = lut(config.dark_lut if config.dark_lut is not None
               else identity_lut())
    bright = lut(config.bright_lut) if config.bright_lut is not None \
        else dark
    light = lightmap * inverse_scale

    weight = light[..., :3]
    # Rounded to float32 like the JAX package's clipped scalar; it stays a
    # Python float on the host.
    band_width = float(np.float32(
        min(max(config.bright_level - config.dark_level, 0.0), 1.0)))
    neutral = min(config.neutral_band_size, band_width - 0.01)
    has_neutral = neutral > 0.0
    if (not config.per_channel) or has_neutral:
        w = RGB_TO_LUMINANCE
        weight = (weight[..., 0:1] * w[0] + weight[..., 1:2] * w[1]
                  + weight[..., 2:3] * w[2])

    base = torch.clamp(albedo[..., :3], 0.0, 1.0)
    v1 = sample_lut(dark, base)
    v2 = sample_lut(bright, base)

    if has_neutral:
        transition = (band_width - neutral) * 0.5
        v = weight[..., :1] - config.dark_level
        v3 = v - transition - neutral
        t1 = torch.clamp(v / max(transition, 1e-6), 0.0, 1.0)
        t2 = torch.clamp(v3 / max(transition, 1e-6), 0.0, 1.0)
        val1 = v1 + (base - v1) * t1
        blended = val1 + (v2 - val1) * t2
    else:
        wgt = weight - config.dark_level
        if config.bright_level > config.dark_level:
            wgt = torch.clamp(
                wgt / (config.bright_level - config.dark_level), 0.0, 1.0)
        else:
            wgt = torch.clamp(wgt, 0.0, 1.0)
        blended = v1 + (v2 - v1) * wgt

    out_rgb = blended if config.lut_only else blended * light[..., :3]
    return torch.cat([out_rgb, albedo[..., 3:4]], dim=-1)
