"""Lightmap resolve: HDR -> displayable image, optionally combined with
albedo.

Counterpart of illuminant_tpu/raster/resolve.py: the six variants of
Resolve.fx ({plain, gamma-compressed, tonemapped} x {with, without
albedo}), the sRGB output of premultiplied values, the ordered dither, the
uint8 quantization and HDRBitmap.fx. The lightmap is full-intensity
float32, so `inverse_scale` defaults to 1 and the albedo combine is
albedo -> lerp(albedo, albedo * light.rgb, saturate(light.a)). Every
function is pointwise and runs on the device of its input; the HDRConfig
values are Python scalars and cost no device read.
"""

from __future__ import annotations

import torch

from ..core.config import (HDR_MODE_GAMMA_COMPRESS, HDR_MODE_NONE,
                           HDR_MODE_TONEMAP, HDRConfig)
from ..ops import tonemap


def _uncharted2_resolve(rgb, hdr: HDRConfig, floor: float = 0.0):
    """The tonemapped operator: offset -> exposure -> Uncharted2 ->
    white-point normalize -> gamma (Resolve.fx:124-133 / HDRBitmap.fx),
    shared by the lightmap and the bitmap paths."""
    pre = torch.clamp(rgb + hdr.offset, min=0.0) * hdr.exposure
    white = max(tonemap.uncharted2_tonemap(float(hdr.white_point)), 1e-6)
    mapped = tonemap.uncharted2_tonemap(pre) / white
    return torch.clamp(mapped, min=floor) ** hdr.gamma


def _apply_mode(result, hdr: HDRConfig, average_luminance):
    if hdr.mode == HDR_MODE_TONEMAP:
        return _uncharted2_resolve(result[..., :3], hdr)
    if hdr.mode == HDR_MODE_GAMMA_COMPRESS:
        return tonemap.gamma_compress(
            result, hdr.offset, hdr.middle_gray, average_luminance,
            hdr.maximum_luminance_sq)[..., :3]
    if hdr.mode != HDR_MODE_NONE:
        raise ValueError(f"unknown HDR mode {hdr.mode!r}")
    rgb = torch.clamp(result[..., :3] + hdr.offset, min=0.0) * hdr.exposure
    return torch.clamp(rgb, min=1e-12) ** hdr.gamma


def _srgb_premultiplied(rgb, alpha):
    """pLinearToPSRGB: un-premultiply, apply the sRGB OETF, re-premultiply
    (the OETF on premultiplied values would brighten translucent
    pixels)."""
    straight = torch.clamp(rgb / torch.clamp(alpha, min=1e-6), 0.0, 1.0)
    return tonemap.linear_to_srgb(straight) * torch.clamp(alpha, 0.0, 1.0)


def _dither(rgb):
    h, w = rgb.shape[:2]
    return tonemap.ordered_dither(
        rgb, torch.arange(h, device=rgb.device)[:, None],
        torch.arange(w, device=rgb.device)[None, :])


def _finish(result, hdr: HDRConfig, average_luminance):
    """Operator, sRGB output and dither of a combined (H, W, 4) image."""
    rgb = _apply_mode(result, hdr, average_luminance)
    if hdr.srgb_output:
        rgb = _srgb_premultiplied(torch.clamp(rgb, 0.0, 1.0),
                                  result[..., 3:4])
    if hdr.dithering:
        rgb = _dither(rgb)
    return torch.cat([rgb, result[..., 3:4]], dim=-1)


def resolve(lightmap, hdr: HDRConfig = HDRConfig(), albedo=None,
            inverse_scale: float = 1.0, average_luminance: float = 0.5,
            albedo_is_srgb: bool = False):
    """lightmap (H, W, 4) HDR -> (H, W, 4) display-linear (or sRGB)
    float32.

    `average_luminance` (a float or a 0-d tensor) feeds the gamma
    compression. `albedo` (H, W, 3 or 4): a 3-channel albedo is opaque.
    `albedo_is_srgb` linearizes an sRGB-authored albedo before the light
    combine (AlbedoIsSRGB, Resolve.fx:52-53)."""
    light = lightmap * inverse_scale
    if albedo is not None:
        if albedo.shape[-1] < 4:
            albedo = torch.cat([albedo, torch.ones_like(albedo[..., :1])],
                               dim=-1)
        if albedo_is_srgb:
            # pSRGBToPLinear on the premultiplied albedo (fx:52-53).
            a = torch.clamp(albedo[..., 3:4], min=1e-6)
            lin = tonemap.srgb_to_linear(
                torch.clamp(albedo[..., :3] / a, 0.0, 1.0)) * a
            albedo = torch.cat([lin, albedo[..., 3:4]], dim=-1)
        # ResolveWithAlbedoCommon (Resolve.fx:43-62).
        result = torch.cat([
            albedo[..., :3]
            + (albedo[..., :3] * light[..., :3] - albedo[..., :3])
            * torch.clamp(light[..., 3:4], 0.0, 1.0),
            albedo[..., 3:4]], dim=-1)
    else:
        result = torch.cat([light[..., :3],
                            torch.ones_like(light[..., 3:4])], dim=-1)
    return _finish(result, hdr, average_luminance)


def to_uint8(image):
    """Quantize a resolved (H, W, C) float32 image to uint8 (round half to
    even, like the JAX package)."""
    return torch.clamp(torch.round(image * 255.0), 0.0, 255.0).to(torch.uint8)


def hdr_bitmap(texture, hdr: HDRConfig = HDRConfig(),
               multiply_color=(1.0, 1.0, 1.0, 1.0),
               add_color=(0.0, 0.0, 0.0, 0.0), inverse_scale: float = 1.0,
               average_luminance: float = 0.5):
    """HDRBitmap.fx: the operator of `hdr.mode` on an arbitrary HDR bitmap
    (H, W, 4) with the multiply / add colour combine (HDRBitmap.fx:8-42):
    the add colour is premultiplied and applied scaled by the result's
    alpha. HDR_MODE_NONE is resolve()'s plain exposure / gamma pass;
    srgb_output and dithering are honoured as in resolve()."""
    mul = torch.tensor(multiply_color, dtype=torch.float32,
                       device=texture.device)
    a = float(add_color[3])
    add = torch.tensor([add_color[0] * a, add_color[1] * a, add_color[2] * a,
                        0.0], dtype=torch.float32, device=texture.device)
    result = mul * (texture * inverse_scale)
    result = result + add * result[..., 3:4]
    return _finish(result, hdr, average_luminance)
