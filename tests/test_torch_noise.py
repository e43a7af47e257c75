"""The port's randomness field against the JAX package's: the sampling
of a carried field is gathers and lerps, so it agrees exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from illuminant_tpu.ops import noise as jnoise
from illuminant_tpu_torch.core import interop
from illuminant_tpu_torch.ops import noise

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def fields():
    """A small JAX field and the port's copy of it."""
    jf = jnoise.RandomField.create(jax.random.key(3), height=37, width=53)
    tf = interop.to_torch(noise.RandomField, interop.as_numpy_fields(jf),
                          device="cpu")
    return jf, tf


def _points(n=3000, seed=0):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-300.0, 300.0, (n, 2)).astype(np.float32)
    xy[:8] = [[0, 0], [-0.5, 0.5], [52.5, 36.5], [53, 37], [-53, -37],
              [0.49999, 1e-7], [1e4, -1e4], [106.0, 74.0]]
    return xy


def test_create_draws_uniform_on_the_device():
    a = noise.RandomField.create(torch.Generator().manual_seed(7),
                                 height=20, width=30, device="cpu")
    b = noise.RandomField.create(torch.Generator().manual_seed(7),
                                 height=20, width=30, device="cpu")
    assert a.shape == (20, 30) and a.data.shape == (20, 30, 4)
    assert torch.equal(a.data, b.data)
    assert 0.0 <= float(a.data.min()) and float(a.data.max()) < 1.0
    assert noise.RandomField.create(device="cpu").data.shape == (
        noise.DEFAULT_HEIGHT, noise.DEFAULT_WIDTH, 4)


@pytest.mark.parametrize("rate", [1.0, (0.25, 2.0)])
@pytest.mark.parametrize("sample", ["point_sample", "bilinear_sample"])
def test_sampling_matches_jax(fields, sample, rate):
    jf, tf = fields
    xy = _points()
    offset = np.asarray([17.25, -3.5], np.float32)
    r = rate if isinstance(rate, float) else np.asarray(rate, np.float32)
    want = np.asarray(getattr(jnoise, sample)(
        jf, jnp.asarray(xy), jnp.asarray(offset),
        r if isinstance(r, float) else jnp.asarray(r)))
    got = getattr(noise, sample)(
        tf, torch.as_tensor(xy), torch.as_tensor(offset),
        r if isinstance(r, float) else torch.as_tensor(r)).numpy()
    # Point sampling gathers; bilinear is two lerps of gathered texels in
    # the same order, elementwise float32 on both sides: exact.
    np.testing.assert_array_equal(got, want)
