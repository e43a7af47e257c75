"""Public helpers of ported modules that no entry point of the port
reaches (ROADMAP M16), each against its JAX function on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from illuminant_tpu.lighting import environment as jenv
from illuminant_tpu.lighting import probes as jprobes
from illuminant_tpu.ops import bezier as jbezier
from illuminant_tpu.ops import coords as jcoords
from illuminant_tpu.particles import transforms as jtx
from illuminant_tpu.sdf import sampling as jsampling
from illuminant_tpu.sdf import volume as jvol
from illuminant_tpu_torch.core import interop
from illuminant_tpu_torch.lighting import probes
from illuminant_tpu_torch.ops import bezier, coords
from illuminant_tpu_torch.particles import transforms as tx
from illuminant_tpu_torch.sdf import sampling
from illuminant_tpu_torch.sdf.volume import SdfVolume

torch.set_num_threads(1)


def _normals(n=300, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3)).astype(np.float32)
    v[:20, 0] = rng.uniform(-2e-4, 2e-4, 20)  # the |x| < 1e-4 clamp
    v[20:24] = [[0, 0, 1], [0, 0, -1], [-1, 0, 0], [0, -1, 0]]
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def test_encode_normal_spherical_matches_jax():
    """Encode (coords.py:19) against the JAX function, and decode after
    encode gives the normal back away from the clamped x."""
    n = _normals()
    enc = coords.encode_normal_spherical(torch.as_tensor(n)).numpy()
    ref = np.asarray(jcoords.encode_normal_spherical(jnp.asarray(n)))
    np.testing.assert_allclose(enc, ref, rtol=1e-6, atol=1e-6)
    back = coords.decode_normal_spherical(torch.as_tensor(enc)).numpy()
    np.testing.assert_allclose(back[24:], n[24:], atol=1e-5)


@pytest.mark.parametrize("axis", [-1, 0])
def test_normalize_and_vlength_match_jax(axis):
    rng = np.random.default_rng(1)
    v = rng.normal(size=(40, 3)).astype(np.float32)
    v[0] = 0.0  # the eps floor keeps a zero vector at zero
    t = torch.as_tensor(v)
    np.testing.assert_allclose(
        coords.normalize(t, axis=axis).numpy(),
        np.asarray(jcoords.normalize(jnp.asarray(v), axis=axis)),
        rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        coords.vlength(t, axis=axis).numpy(),
        np.asarray(jcoords.vlength(jnp.asarray(v), axis=axis)),
        rtol=1e-6)
    assert np.all(np.isfinite(coords.normalize(t, axis=axis).numpy()))


def test_dynamic_matrix_from_matrix_matches_jax():
    """An explicit matrix regenerates to itself, and every field equals
    the JAX package's (tests/test_misc_kernels.py:48-51 uses it)."""
    m = np.arange(16, dtype=np.float32).reshape(4, 4) / 7.0
    dm = bezier.DynamicMatrix.from_matrix(m)
    jm = jbezier.DynamicMatrix.from_matrix(m)
    for name in ("matrix", "angle", "scale", "translation", "is_dynamic"):
        np.testing.assert_array_equal(getattr(dm, name).numpy(),
                                      np.asarray(getattr(jm, name)))
    np.testing.assert_array_equal(dm.regenerate().numpy(), m)


def test_area_uniforms_everywhere_matches_jax():
    a = tx.AreaUniforms.everywhere(0.75)
    j = jtx.AreaUniforms.everywhere(0.75)
    for name in ("type", "center", "size", "falloff", "rotation", "strength"):
        got, want = getattr(a, name).numpy(), np.asarray(getattr(j, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want)
    pts = torch.as_tensor(np.random.default_rng(2).uniform(
        -50, 50, (16, 3)).astype(np.float32))
    np.testing.assert_array_equal(tx.area_weight(pts, a).numpy(), 0.75)


def test_sample_or_max_matches_jax():
    """No field: the maximum everywhere; a field: the exact sample."""
    env = jenv.LightingEnvironment()
    env.obstructions.append(jenv.LightObstruction.box((40.0, 30.0, 16.0),
                                                      (8.0, 6.0, 16.0)))
    cfg = jvol.SdfVolumeConfig(virtual_width=96, virtual_height=64,
                               virtual_depth=64, slice_count=16,
                               resolution_scale=0.5)
    vj = jvol.generate_volume(cfg, env.pack_obstructions())
    vt = interop.to_torch(SdfVolume, interop.as_numpy_fields(vj),
                          device="cpu")
    pts = np.random.default_rng(3).uniform(
        [-10, -10, -5], [110, 80, 70], (200, 3)).astype(np.float32)
    for volumes in ((None, None), (vt, vj)):
        for mz in (128.0, 40.0):
            got = sampling.sample_or_max(volumes[0], torch.as_tensor(pts),
                                         mz).numpy()
            want = np.asarray(jsampling.sample_or_max(
                volumes[1], jnp.asarray(pts), mz))
            assert got.shape == want.shape == (200,)
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_probe_points_gbuffer_properties_match_jax():
    """`render_scale`, `relative_y` and `z` of the probe buffer, the
    G-buffer properties the JAX package's duck-typed buffer offers."""
    host = [(10.0, 20.0, 3.0), (0.5, -4.0, 40.0), (70.0, 8.0, 0.0)]
    pt = probes.probe_points(probes.pack_probes(
        [probes.LightProbe(position=p) for p in host], capacity=5,
        device="cpu"))
    pj = jprobes.probe_points(jprobes.pack_probes(
        [jprobes.LightProbe(position=p) for p in host], capacity=5))
    assert pt.render_scale == pj.render_scale == 1.0
    for name in ("relative_y", "z"):
        got, want = getattr(pt, name).numpy(), np.asarray(getattr(pj, name))
        assert got.shape == want.shape == (5, 1)
        np.testing.assert_array_equal(got, want)
