"""Randomness field (counterpart of illuminant_tpu/ops/noise.py).

The reference's randomness textures (807x653 Vector4, ParticleEngine.cs:
495-544) become one (H, W, 4) float32 tensor drawn once, sampled with wrap
addressing: point sampling for per-slot randomness (`random`,
RandomCommon.fxh:27-34) and bilinear for smooth spatial noise
(`smoothRandom`, :36-43). The JAX package draws its field from a threefry
key, which PyTorch cannot reproduce: `create` draws from a torch.Generator,
and a test carries the JAX field across (core/interop.py).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.pytree import tensor_dataclass

# Reference texture dimensions (ParticleEngine.cs:497).
DEFAULT_WIDTH = 807
DEFAULT_HEIGHT = 653


@tensor_dataclass
class RandomField:
    data: torch.Tensor  # (H, W, 4) float32 in [0, 1)

    @staticmethod
    def create(generator: Optional[torch.Generator] = None,
               height: int = DEFAULT_HEIGHT, width: int = DEFAULT_WIDTH,
               device="cuda") -> "RandomField":
        """Uniform draws from `generator` (on `device`; None uses the
        device's default generator)."""
        return RandomField(data=torch.rand(
            (height, width, 4), generator=generator, dtype=torch.float32,
            device=device))

    @property
    def shape(self):
        return tuple(self.data.shape[:2])


def point_sample(field: RandomField, xy, offset, rate=1.0):
    """randomCustom (RandomCommon.fxh:27-30): point sample with wrap.
    xy (..., 2); offset (2,); rate a scalar or (2,)."""
    h, w = field.shape
    coord = xy * rate + offset
    xi = torch.remainder(torch.floor(coord[..., 0]).to(torch.int64), w)
    yi = torch.remainder(torch.floor(coord[..., 1]).to(torch.int64), h)
    return field.data[yi, xi]


def bilinear_sample(field: RandomField, xy, offset, rate=1.0):
    """smoothRandomCustom (RandomCommon.fxh:36-39): bilinear with wrap,
    texel centres at i + 0.5."""
    h, w = field.shape
    coord = xy * rate + offset
    tx = coord[..., 0] - 0.5
    ty = coord[..., 1] - 0.5
    x0 = torch.floor(tx)
    y0 = torch.floor(ty)
    wx = (tx - x0)[..., None]
    wy = (ty - y0)[..., None]
    x0i = torch.remainder(x0.to(torch.int64), w)
    x1i = torch.remainder(x0i + 1, w)
    y0i = torch.remainder(y0.to(torch.int64), h)
    y1i = torch.remainder(y0i + 1, h)
    v00 = field.data[y0i, x0i]
    v01 = field.data[y0i, x1i]
    v10 = field.data[y1i, x0i]
    v11 = field.data[y1i, x1i]
    top = v00 + (v01 - v00) * wx
    bot = v10 + (v11 - v10) * wx
    return top + (bot - top) * wy
