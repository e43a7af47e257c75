"""The port's screen-space warps (`raster/warp.py`) against the JAX
package's on the CPU, at 64 x 96.

Both sample with the same explicit four-tap bilinear (pixel centres at
i + 0.5, taps clamped to the edge), so they agree to float32 rounding
(XLA's CPU backend fuses some products and sums into one rounding):
1e-5 relative plus 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from illuminant_tpu.raster import warp as jwarp
from illuminant_tpu_torch.raster import warp

H, W = 64, 96


def _background(channels=4, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    base = np.stack([np.sin(xx * 0.3) * 0.5 + 0.5,
                     np.cos(yy * 0.2) * 0.5 + 0.5,
                     ((xx + yy) % 7) / 7.0, np.ones((H, W))], -1)
    base = base + rng.uniform(0, 0.05, base.shape)
    return base[..., :channels].astype(np.float32)


def _swirl_field(mask="ones"):
    """demo.py:863-882's rotational field, stored like a texture (0.5 =
    no displacement), with a zero-length region and a partial mask."""
    ys, xs = np.meshgrid(np.linspace(-1, 1, H), np.linspace(-1, 1, W),
                         indexing="ij")
    r = np.sqrt(xs ** 2 + ys ** 2)
    swirl = np.exp(-((r - 0.55) ** 2) / 0.02)
    field = np.stack([-ys * swirl, xs * swirl], -1).astype(np.float32)
    alpha = np.ones((H, W, 1), np.float32)
    if mask == "partial":
        alpha[:, : W // 3] = 0.0
        alpha[:, W // 3: W // 2] = 0.5
        alpha[: H // 4] = 1.0 / 255.0
    return np.concatenate([field * 0.5 + 0.5,
                           np.full((H, W, 1), 0.5, np.float32), alpha], -1)


@pytest.mark.parametrize("case", [
    dict(intensity=(24.0, 24.0, 0.0)),
    dict(intensity=(8.0, -5.0, 0.0), mask="partial"),
    dict(intensity=(40.0, 40.0, 0.0), multiply_color=(0.5, 1.0, 2.0, 1.0)),
    dict(intensity=(6.0, 6.0, 0.0), channels=3),
])
def test_vector_warp_matches_jax(case):
    case = dict(case)
    bg = _background(case.pop("channels", 4))
    field = _swirl_field(case.pop("mask", "ones"))
    ref = np.asarray(jwarp.vector_warp(jnp.asarray(bg), jnp.asarray(field),
                                       **case))
    out = warp.vector_warp(torch.as_tensor(bg), torch.as_tensor(field),
                           **case)
    assert out.shape == ref.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    # The field moves the image where it is strong; masked pixels are 0.
    assert np.abs(ref - bg * (field[..., 3:4] > 0.5 / 255)).max() > 0.1


@pytest.mark.parametrize("case", [
    dict(),
    dict(refraction_index=1.4, strength=10.0),
    dict(normals_signed=True, strength=24.0),
])
def test_normal_refraction_warp_matches_jax(case):
    rng = np.random.default_rng(1)
    n = rng.normal(0, 0.4, (H, W, 3)) + np.asarray([0, 0, 1.0])
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    if not case.get("normals_signed"):
        n = n * 0.5 + 0.5
    alpha = rng.uniform(0, 1, (H, W, 1))
    normals = np.concatenate([n, alpha], -1).astype(np.float32)
    bg = _background(seed=2)
    ref = np.asarray(jwarp.normal_refraction_warp(
        jnp.asarray(bg), jnp.asarray(normals), **case))
    out = warp.normal_refraction_warp(torch.as_tensor(bg),
                                      torch.as_tensor(normals), **case)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    assert np.abs(ref - bg).max() > 0.05


def test_bilinear_clamps_and_centres_like_jax():
    """Samples past every edge and on texel centres."""
    img = _background(seed=3)
    ys = np.asarray([-5.0, 0.0, 0.5, 31.5, 63.5, 64.0, 70.0], np.float32)
    xs = np.asarray([-3.0, 0.25, 0.5, 47.5, 95.5, 96.0, 99.0], np.float32)
    yy, xx = np.meshgrid(ys, xs, indexing="ij")
    ref = np.asarray(jwarp._bilinear(jnp.asarray(img), jnp.asarray(yy),
                                     jnp.asarray(xx)))
    out = warp._bilinear(torch.as_tensor(img), torch.as_tensor(yy),
                         torch.as_tensor(xx))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(out.numpy()[2, 2], img[0, 0], atol=1e-6)


def test_warps_follow_their_inputs():
    """NumPy inputs give CPU tensors; the result lies where the inputs
    do."""
    bg, field = _background(), _swirl_field()
    out = warp.vector_warp(bg, field)
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    out = warp.normal_refraction_warp(torch.as_tensor(bg), field)
    assert out.device.type == "cpu" and out.shape == (H, W, 4)
