"""HDR tonemapping and gamma-compression operators (counterpart of
illuminant_tpu/ops/tonemap.py): Rec.601 luma (HDR.fxh:9), GammaCompress
(HDR.fxh:11-18), the Uncharted2 filmic curve (HDR.fxh:24-45), the sRGB
transfer functions and the ordered dither of the resolve. All pointwise
functions of tensors; scalars may be Python floats."""

from __future__ import annotations

import torch

RGB_TO_LUMINANCE = (0.299, 0.587, 0.114)

_KA, _KB, _KC, _KD, _KE, _KF = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30

_BAYER_4X4 = ((0, 8, 2, 10), (12, 4, 14, 6), (3, 11, 1, 9), (15, 7, 13, 5))


def luminance(rgb):
    """(..., 3) -> (...,) luma, in float32 whatever the input type."""
    rgb = rgb.float()
    w = RGB_TO_LUMINANCE
    return rgb[..., 0] * w[0] + rgb[..., 1] * w[1] + rgb[..., 2] * w[2]


def uncharted2_tonemap(rgb):
    """Filmic curve (HDR.fxh:31-45) on exposure-scaled linear RGB (a tensor
    or a Python float)."""
    v = rgb
    return ((v * (_KA * v + _KC * _KB) + _KD * _KE)
            / (v * (_KA * v + _KB) + _KD * _KF)) - _KE / _KF


def uncharted2_resolve(rgba, exposure, white_point):
    """Exposure, curve, white-point normalize on (..., 4); alpha passes
    through (Resolve.fx ToneMappedResolveCommon)."""
    mapped = uncharted2_tonemap(rgba[..., :3] * exposure)
    white = uncharted2_tonemap(white_point)
    white = (torch.clamp(white, min=1e-6) if torch.is_tensor(white)
             else max(white, 1e-6))
    return torch.cat([mapped / white, rgba[..., 3:4]], dim=-1)


def gamma_compress(rgba, offset, middle_gray, average_luminance,
                   maximum_luminance_sq):
    """Reinhard-style luminance compression (HDR.fxh:11-18) on (..., 4)."""
    rgb = torch.clamp(rgba[..., :3] + offset, min=0.0)
    lum = luminance(rgb)
    avg = (torch.clamp(average_luminance, min=1e-6)
           if torch.is_tensor(average_luminance)
           else max(average_luminance, 1e-6))
    scaled = (lum * middle_gray) / avg
    compressed = (scaled * (1.0 + scaled / maximum_luminance_sq)) \
        / (1.0 + scaled)
    rescale = compressed / torch.clamp(lum, min=1e-6)
    return torch.cat([rgb * rescale[..., None], rgba[..., 3:4]], dim=-1)


def apply_exposure_gamma(rgba, exposure, gamma):
    """Exposure multiply and power gamma (Resolve.fx exposure / gamma)."""
    rgb = torch.clamp(rgba[..., :3] * exposure, min=0.0) ** gamma
    return torch.cat([rgb, rgba[..., 3:4]], dim=-1)


def srgb_to_linear(rgb):
    """Inverse sRGB OETF (the per-channel core of pSRGBToPLinear)."""
    lo = rgb / 12.92
    hi = ((rgb + 0.055) / 1.055) ** 2.4
    return torch.where(rgb <= 0.04045, lo, hi)


def linear_to_srgb(rgb):
    """sRGB OETF (the sRGB output path of Resolve.fx)."""
    low = rgb * 12.92
    high = 1.055 * torch.clamp(rgb, min=1e-8) ** (1.0 / 2.4) - 0.055
    return torch.where(rgb <= 0.0031308, low, high)


def ordered_dither(rgb, pixel_y, pixel_x, strength=1.0 / 255.0):
    """4x4 Bayer ordered dither: `pixel_y` / `pixel_x` are integer tensors
    that broadcast to rgb's leading shape."""
    bayer = torch.tensor(_BAYER_4X4, dtype=torch.float32,
                         device=rgb.device) / 16.0 - 0.5
    offs = bayer[pixel_y % 4, pixel_x % 4]
    return rgb + offs[..., None] * strength
