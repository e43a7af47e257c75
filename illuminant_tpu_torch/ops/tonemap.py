"""HDR tonemapping (counterpart of illuminant_tpu/ops/tonemap.py, the parts
the flagship resolve uses): Rec.601 luma (HDR.fxh:9) and the Uncharted2
filmic curve (HDR.fxh:24-45)."""

from __future__ import annotations

RGB_TO_LUMINANCE = (0.299, 0.587, 0.114)

_KA, _KB, _KC, _KD, _KE, _KF = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30


def luminance(rgb):
    """(..., 3) -> (...,) luma, in float32 whatever the input type."""
    rgb = rgb.float()
    w = RGB_TO_LUMINANCE
    return rgb[..., 0] * w[0] + rgb[..., 1] * w[1] + rgb[..., 2] * w[2]


def uncharted2_tonemap(rgb):
    """Filmic curve (HDR.fxh:31-45) on exposure-scaled linear RGB."""
    v = rgb
    return ((v * (_KA * v + _KC * _KB) + _KD * _KE)
            / (v * (_KA * v + _KB) + _KD * _KF)) - _KE / _KF
