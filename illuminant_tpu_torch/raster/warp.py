"""Screen-space warps: vector-field displacement and normal refraction
(counterpart of illuminant_tpu/raster/warp.py; VectorWarp.fx).

A vector-field texture displaces background pixels (VectorWarpPixelShader
:28-60: field values unpack to signed directions, normalized and scaled by
the field intensity, the field's alpha masking the result), and
NormalRefraction (:62-101) bends a straight-down view ray through a normal
map. Both sample the background with the JAX package's explicit four-tap
bilinear (pixel centres at i + 0.5, taps clamped to the edge). The
functions run on their inputs' device.
"""

from __future__ import annotations

import torch


def _tensor(v, like=None):
    if isinstance(v, torch.Tensor):
        return v.to(torch.float32)
    return torch.as_tensor(v, dtype=torch.float32,
                           device=None if like is None else like.device)


def _bilinear(img, y, x):
    """img (H, W, C) sampled at pixel coordinates y, x (H', W') -> (H', W',
    C): the taps around (y - 0.5, x - 0.5), indices clamped to the image."""
    h, w = img.shape[0], img.shape[1]
    ty = y - 0.5
    tx = x - 0.5
    y0 = torch.floor(ty)
    x0 = torch.floor(tx)
    fy = (ty - y0)[..., None]
    fx = (tx - x0)[..., None]
    y0i = torch.clamp(y0.to(torch.int64), 0, h - 1)
    y1i = torch.clamp(y0i + 1, 0, h - 1)
    x0i = torch.clamp(x0.to(torch.int64), 0, w - 1)
    x1i = torch.clamp(x0i + 1, 0, w - 1)
    v00 = img[y0i, x0i]
    v01 = img[y0i, x1i]
    v10 = img[y1i, x0i]
    v11 = img[y1i, x1i]
    top = v00 + (v01 - v00) * fx
    bot = v10 + (v11 - v10) * fx
    return top + (bot - top) * fy


def _pixel_centres(h, w, device):
    ys = torch.arange(h, dtype=torch.float32, device=device)[:, None] + 0.5
    xs = torch.arange(w, dtype=torch.float32, device=device)[None, :] + 0.5
    return ys, xs


def vector_warp(background, field, intensity=(8.0, 8.0, 0.0),
                multiply_color=(1.0, 1.0, 1.0, 1.0)):
    """background (H, W, C); field (H, W, 4), xyz in [0, 1] encoding signed
    directions and alpha the effect mask -> warped (H, W, C)."""
    background = _tensor(background)
    field = _tensor(field, background)
    h, w = background.shape[0], background.shape[1]
    fv = (field[..., :3] - 0.5) * 2.0
    length = torch.sqrt(torch.clamp(torch.sum(fv * fv, dim=-1, keepdim=True),
                                    min=1e-12))
    direction = torch.where(length >= 0.01, fv / length, 0.0)
    offs = direction * _tensor(intensity, background)
    ys, xs = _pixel_centres(h, w, background.device)
    warped = _bilinear(background, ys + offs[..., 1], xs + offs[..., 0])
    out = warped * _tensor(multiply_color, background)[
        ..., :background.shape[-1]]
    alpha = field[..., 3:4]
    return torch.where(alpha > 0.5 / 255.0, out * alpha, 0.0)


def normal_refraction_warp(background, normals, refraction_index=0.9,
                           normals_signed: bool = False,
                           strength: float = 16.0):
    """NormalRefraction (VectorWarp.fx:62-101): refract a straight-down
    view ray through the normal map (H, W, 4; alpha the mask) and sample
    the displaced background (H, W, C)."""
    background = _tensor(background)
    normals = _tensor(normals, background)
    h, w = background.shape[0], background.shape[1]
    n = normals[..., :3]
    if not normals_signed:
        n = (n - 0.5) * 2.0
    n = n / torch.sqrt(torch.clamp(torch.sum(n * n, dim=-1, keepdim=True),
                                   min=1e-12))
    ray = torch.tensor([0.0, 0.0, -1.0], dtype=torch.float32,
                       device=background.device)
    # Snell refraction of `ray` about n.
    cos_i = -torch.sum(ray * n, dim=-1, keepdim=True)
    eta = refraction_index
    k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    refracted = eta * ray + (eta * cos_i
                             - torch.sqrt(torch.clamp(k, min=0.0))) * n
    offs = refracted[..., :2] * strength
    ys, xs = _pixel_centres(h, w, background.device)
    warped = _bilinear(background, ys + offs[..., 1], xs + offs[..., 0])
    alpha = normals[..., 3:4]
    return warped * alpha + background * (1.0 - alpha)
