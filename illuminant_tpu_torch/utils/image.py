"""Image helpers: IO (the port's copy of illuminant_tpu/utils/image.py:
numpy and PIL only, PIL imported inside the call) and `resize_linear`,
the port's copy of jax.image.resize(..., "linear")."""

from __future__ import annotations

import numpy as np
import torch


def write_png(path: str, image) -> None:
    """Write an (H, W), (H, W, 3) or (H, W, 4) uint8 or float-in-[0, 1]
    image (a numpy array or a tensor on any device) as PNG."""
    from PIL import Image

    if hasattr(image, "detach"):
        image = image.detach().cpu().numpy()
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = np.clip(np.round(arr * 255.0), 0, 255).astype(np.uint8)
    if arr.ndim == 2:
        mode = "L"
    elif arr.shape[-1] == 3:
        mode = "RGB"
    else:
        mode = "RGBA"
    Image.fromarray(arr, mode=mode).save(path)


def read_png(path: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path))


def _linear_weights(n_in: int, n_out: int, device):
    """(n_in, n_out) float32 weights of jax.image.resize's linear method
    on one axis (jax/_src/image/scale.py:compute_weight_mat with the
    triangle kernel, antialiased): the kernel widened by 1 / scale when
    downsampling, each output's weights renormalized to sum 1 (0 where the
    sum is below 1000 eps), and 0 for outputs whose sample lies outside
    the input."""
    f32 = torch.float32
    scale = torch.tensor(n_out / n_in, dtype=f32, device=device)
    inv_scale = 1.0 / scale
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = (torch.arange(n_out, dtype=f32, device=device) + 0.5) \
        * inv_scale - 0.5
    x = torch.abs(sample_f[None, :] - torch.arange(
        n_in, dtype=f32, device=device)[:, None]) / kernel_scale
    weights = torch.clamp(1.0 - torch.abs(x), min=0.0)
    total = torch.sum(weights, dim=0, keepdim=True)
    weights = torch.where(
        torch.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
        weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], weights, 0.0)


def resize_linear(x, shape):
    """What jax.image.resize(x, shape, "linear") computes, in float32:
    every axis whose size changes is resampled by the triangle kernel
    (widened by the ratio when downsampling, so antialiased), with the
    weights renormalized at the edges; one axis after another."""
    shape = tuple(int(s) for s in shape)
    if len(shape) != x.dim():
        raise ValueError(f"resize_linear: shape {shape} for a "
                         f"{x.dim()}-d tensor")
    out = x.to(torch.float32)
    for axis, (n_in, n_out) in enumerate(zip(x.shape, shape)):
        if n_in == n_out:
            continue
        w = _linear_weights(n_in, n_out, x.device)
        out = torch.tensordot(out.movedim(axis, -1), w, dims=1) \
            .movedim(-1, axis)
    return out
