"""Spherical-harmonics GI probes (lighting/spherical_harmonics.py) in the
port against the JAX package, mirroring tests/test_spherical_harmonics.py
on the same numpy inputs. Tolerance: 1e-6 of the largest reference value
(the basis is elementwise float32 on both sides; the projection's sums
over the samples run in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from illuminant_tpu.lighting import spherical_harmonics as jsh
from illuminant_tpu_torch.lighting import spherical_harmonics as tsh

REL = 1e-6


def _close(out, ref):
    out = out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape and out.dtype == np.float32
    scale = float(np.abs(ref).max())
    assert float(np.abs(out - ref).max()) <= REL * scale, (
        float(np.abs(out - ref).max()), scale)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def test_basis_and_cosine_lobe_match_jax():
    rng = np.random.default_rng(0)
    d = rng.normal(size=(64, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[0] = [0.0, 0.0, 1.0]
    _close(tsh.sh9_basis(_t(d)), jsh.sh9_basis(jnp.asarray(d)))
    _close(tsh.sh_cosine_lobe(_t(d)), jsh.sh_cosine_lobe(jnp.asarray(d)))
    b = tsh.sh9_basis(_t(d[0])).numpy()
    np.testing.assert_allclose(b[[0, 2, 6]], [0.282095, 0.488603,
                                              0.315392 * 2.0], atol=1e-6)


def test_fibonacci_sphere_is_the_jax_package_s():
    np.testing.assert_array_equal(tsh.fibonacci_sphere(257),
                                  jsh.fibonacci_sphere(257))


@pytest.mark.parametrize("case", ["constant", "lobe"])
def test_projection_and_irradiance_match_jax(case):
    """Uniform white radiance (irradiance 1 for every normal), and all
    radiance from +z (a peak up, ~0 down)."""
    n = 512 if case == "constant" else 2048
    dirs = jsh.fibonacci_sphere(n)
    if case == "constant":
        rad = np.ones((n, 3), np.float32)
    else:
        rad = np.repeat(np.clip(dirs[:, 2:3], 0, None) ** 16, 3, axis=1)
    sh = tsh.project_radiance(_t(dirs), _t(rad))
    jref = jsh.project_radiance(jnp.asarray(dirs), jnp.asarray(rad))
    _close(sh, jref)
    normals = np.asarray([[0, 0, 1], [1, 0, 0], [0, 0, -1],
                          [0.577, 0.577, 0.577]], np.float32)
    e = tsh.irradiance(sh, _t(normals))
    _close(e, jsh.irradiance(jref, jnp.asarray(normals)))
    if case == "constant":
        np.testing.assert_allclose(e.numpy(), 1.0, rtol=0.02)
    else:
        up, side, down = e.numpy()[[0, 1, 2], 0]
        assert up > 4 * side > 0 and abs(down) < 0.12 * up


def test_bake_probe_from_lights_matches_jax():
    """A red glow from +x over a dim blue ambient (the JAX test), and
    demo.py's GI-probe radiance (scene_gi_probes) at 256 samples."""
    def red(dirs, xp):
        w = xp.clip(dirs[:, 0], 0.0, None)[:, None]
        return w * xp.asarray([2.0, 0.1, 0.0]) + xp.asarray([0.0, 0.0, 0.2])

    def demo(dirs, xp):
        w = xp.clip(dirs[:, 0] * 0.8 + dirs[:, 2] * 0.6, 0.0,
                    None)[:, None] ** 2
        return w * xp.asarray([1.8, 1.2, 0.5]) + xp.asarray(
            [0.05, 0.08, 0.2])

    class TorchNp:
        clip = staticmethod(lambda a, lo, hi: torch.clamp(a, lo, hi))
        asarray = staticmethod(lambda v: torch.tensor(v, dtype=torch.float32))

    for fn, n in ((red, 128), (demo, 256)):
        probe = tsh.GIProbe(position=(10.0, 20.0, 5.0))
        probe.coefficients = tsh.bake_probe_from_lights(
            probe.position, lambda d: fn(d, TorchNp), n_samples=n,
            device="cpu")
        ref = jsh.bake_probe_from_lights(probe.position,
                                         lambda d: fn(d, jnp), n_samples=n)
        _close(probe.coefficients, ref)
    e_x, e_nx = tsh.irradiance(
        tsh.bake_probe_from_lights((0, 0, 0), lambda d: red(d, TorchNp),
                                   device="cpu"),
        _t([[1.0, 0, 0], [-1.0, 0, 0]])).numpy()
    assert e_x[0] > 3 * max(e_nx[0], 1e-3) and e_x[2] > 0.05
