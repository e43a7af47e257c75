"""Voxel field of the port against the JAX package: primitives, volume
generation and composition, exact sampling, and the .npz save/load."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from illuminant_tpu.lighting import environment as jenv
from illuminant_tpu.ops import sdf_primitives as jsp
from illuminant_tpu.sdf import analytic as janalytic
from illuminant_tpu.sdf import sampling as jsampling
from illuminant_tpu.sdf import volume as jvol
from illuminant_tpu_torch.core import interop
from illuminant_tpu_torch.lighting import environment as env_t
from illuminant_tpu_torch.ops import sdf_primitives as sp
from illuminant_tpu_torch.sdf import analytic, sampling
from illuminant_tpu_torch.sdf import volume as vol

torch.set_num_threads(1)

CONFIG = dict(virtual_width=96, virtual_height=64, virtual_depth=64,
              slice_count=16, resolution_scale=0.5)


def _obstructions(mod, dynamic=None):
    e = mod.LightingEnvironment()
    L = mod.LightObstruction
    e.obstructions += [
        L.box((48.0, 32.0, 24.0), (10.0, 8.0, 24.0)),
        L.ellipsoid((20.0, 40.0, 20.0), (12.0, 6.0, 20.0), is_dynamic=True),
        L.cylinder((70.0, 20.0, 10.0), (6.0, 6.0, 10.0), is_dynamic=True),
        L.box((80.0, 50.0, 40.0), (6.0, 4.0, 8.0)),
    ]
    kw = {"device": "cpu"} if mod is env_t else {}
    return e.pack_obstructions(dynamic=dynamic, **kw)


def test_scene_distance_every_type_matches_jax():
    rng = np.random.default_rng(0)
    n = 6
    types = np.asarray([0, 1, 2, 3, 4, 5], np.int32)
    centers = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    sizes = rng.uniform(1, 6, (n, 3)).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q[::2] = (0.0, 0.0, 0.0, 1.0)
    pts = rng.uniform(-12, 12, (500, 3)).astype(np.float32)
    for t in range(6):
        sel = [t]
        ref = np.asarray(jax.jit(jsp.scene_distance)(
            jnp.asarray(pts), jnp.asarray(types[sel]),
            jnp.asarray(centers[sel]), jnp.asarray(sizes[sel]),
            jnp.asarray(q[sel])))
        out = sp.scene_distance(
            torch.as_tensor(pts), torch.as_tensor(types[sel]),
            torch.as_tensor(centers[sel]), torch.as_tensor(sizes[sel]),
            torch.as_tensor(q[sel])).numpy()
        # The same float32 formulas; sqrt/sign ordering may differ by ulps.
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-4,
                                   err_msg=f"type {t}")
    assert sp.KNOWN_TYPES == tuple(sorted(jsp.PLANAR_EVALUATORS))


@pytest.fixture(scope="module")
def volumes():
    cfg_j = jvol.SdfVolumeConfig(**CONFIG)
    cfg_t = vol.SdfVolumeConfig(**CONFIG)
    gen = jax.jit(jvol.generate_volume)
    sj = gen(cfg_j, _obstructions(jenv, dynamic=False))
    dj = gen(cfg_j, _obstructions(jenv, dynamic=True))
    st = vol.generate_volume(cfg_t, _obstructions(env_t, dynamic=False))
    dt = vol.generate_volume(cfg_t, _obstructions(env_t, dynamic=True))
    return (sj, dj), (st, dt)


def test_generate_and_combine_match_jax(volumes):
    (sj, dj), (st, dt) = volumes
    for a, b in ((st, sj), (dt, dj)):
        assert tuple(a.data.shape) == tuple(b.data.shape) == (16, 32, 48)
        np.testing.assert_allclose(a.data.numpy(), np.asarray(b.data),
                                   rtol=1e-5, atol=1e-4)
        assert float(a.max_valid_z) == float(b.max_valid_z)
    # The asymmetric clamp of the encodable band, [-(63/255) m,
    # (192/255) m], bites on both sides at m = 24.
    cfg = dict(CONFIG, max_encoded_distance=24.0)
    small = vol.generate_volume(vol.SdfVolumeConfig(**cfg),
                                _obstructions(env_t))
    small_j = jax.jit(jvol.generate_volume)(jvol.SdfVolumeConfig(**cfg),
                                            _obstructions(jenv))
    np.testing.assert_allclose(small.data.numpy(), np.asarray(small_j.data),
                               rtol=1e-5, atol=1e-4)
    assert float(small.data.max()) == pytest.approx(192.0 / 255.0 * 24.0)
    assert float(small.data.min()) == pytest.approx(-63.0 / 255.0 * 24.0)
    m = 128.0
    ct = vol.combine_static_dynamic(st, dt)
    cj = jvol.combine_static_dynamic(sj, dj)
    np.testing.assert_allclose(ct.data.numpy(), np.asarray(cj.data),
                               rtol=1e-5, atol=1e-4)
    e = vol.encode_distance(ct.data, m)
    np.testing.assert_allclose(vol.decode_distance(e, m).numpy(),
                               ct.data.numpy(), atol=1e-4)
    np.testing.assert_allclose(e.numpy(),
                               np.asarray(jvol.encode_distance(cj.data, m)),
                               atol=1e-6)


def test_sample_and_sample_grid_match_jax(volumes):
    (sj, dj), _ = volumes
    cj = jvol.combine_static_dynamic(sj, dj)
    # The same float32 volume on both sides, so the comparison isolates
    # the samplers.
    ct = interop.to_torch(vol.SdfVolume, interop.as_numpy_fields(cj))
    rng = np.random.default_rng(1)
    p = np.stack([rng.uniform(-8, 104, 3000), rng.uniform(-8, 72, 3000),
                  rng.uniform(-8, 72, 3000)], -1).astype(np.float32)
    ref = np.asarray(jax.jit(jsampling.sample)(cj, jnp.asarray(p)))
    out = sampling.sample(ct, torch.as_tensor(p)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-4)
    nrm = sampling.estimate_normal(ct, torch.as_tensor(p)).numpy()
    nrm_j = np.asarray(jax.jit(jsampling.estimate_normal)(cj,
                                                           jnp.asarray(p)))
    np.testing.assert_allclose(nrm, nrm_j, rtol=1e-4, atol=1e-4)

    xs = (np.arange(40, dtype=np.float32) + 0.5) * 2.5 - 2.0
    ys = (np.arange(28, dtype=np.float32) + 0.5) * 2.5 - 2.0
    for z in (7.5, np.linspace(0.0, 70.0, 40, dtype=np.float32)[None, :]):
        grid = sampling.sample_grid(ct, torch.as_tensor(xs),
                                    torch.as_tensor(ys), torch.as_tensor(z))
        grid_j = jsampling.sample_grid(cj, jnp.asarray(xs), jnp.asarray(ys),
                                       jnp.asarray(z))
        # Both exact trilinear (the JAX one at Precision.HIGHEST).
        np.testing.assert_allclose(grid.numpy(), np.asarray(grid_j),
                                   rtol=1e-5, atol=1e-4)
    # The grid path equals the scattered oracle at the same points.
    gz = sampling.sample_grid(ct, torch.as_tensor(xs), torch.as_tensor(ys),
                              torch.tensor(7.5)).numpy()
    X, Y = np.meshgrid(xs, ys)
    pts = np.stack([X, Y, np.full_like(X, 7.5)], -1)
    np.testing.assert_allclose(
        gz, sampling.sample(ct, torch.as_tensor(pts)).numpy(), atol=1e-4)


def test_save_load_interchange_with_jax(volumes, tmp_path):
    (sj, _), (st, _) = volumes
    # The JAX package writes, the port reads (an extensionless path gets
    # np.savez's .npz suffix, which load accepts too).
    jvol.save(sj, str(tmp_path / "jax_field"))
    got = vol.load(str(tmp_path / "jax_field"))
    assert got.config == vol.SdfVolumeConfig(**CONFIG)
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(sj.data))
    assert got.data.dtype == torch.float32
    # And back.
    vol.save(st, str(tmp_path / "torch_field.npz"))
    back = jvol.load(str(tmp_path / "torch_field.npz"))
    np.testing.assert_array_equal(np.asarray(back.data), st.data.numpy())
    assert back.config == jvol.SdfVolumeConfig(**CONFIG)
    # A fractional depth survives the float64 geometry row.
    frac = vol.SdfVolume(data=st.data, max_valid_z=st.max_valid_z,
                         config=vol.SdfVolumeConfig(**{**CONFIG,
                                                       "virtual_depth": 63.5}))
    vol.save(frac, str(tmp_path / "frac.npz"))
    assert vol.load(str(tmp_path / "frac.npz")).config.virtual_depth == 63.5


def test_pack_scene_groups_like_jax():
    e_j, e_t = jenv.LightingEnvironment(), env_t.LightingEnvironment()
    for e, mod in ((e_j, jenv), (e_t, env_t)):
        L = mod.LightObstruction
        e.obstructions += [L.cylinder((1, 2, 3), (1, 1, 1)),
                           L.box((4, 5, 6), (2, 2, 2)),
                           L.ellipsoid((7, 8, 9), (3, 2, 1)),
                           L.box((1, 1, 1), (0, 1, 1))]
    pj = janalytic.pack_scene(e_j.obstructions, group_capacity_round=1)
    pt = analytic.pack_scene(e_t.obstructions, group_capacity_round=1,
                             device="cpu")
    assert pt.group_types == pj.group_types
    assert pt.group_counts == pj.group_counts
    for a, b in zip(pt.sizes, pj.sizes):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # The port's pack evaluates to the JAX field (its own scale-free
    # points; tests/test_torch_analytic.py holds the field in full).
    pos = np.random.default_rng(0).uniform(-2, 12, (64, 3)).astype(
        np.float32)
    np.testing.assert_allclose(
        analytic.scene_sample(pt, torch.as_tensor(pos)).numpy(),
        np.asarray(pj.distance(pos)), rtol=1e-5, atol=1e-4)
