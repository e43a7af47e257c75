"""The multi-device flagship frame (build_flagship(mesh=...)) against the
single-process frame, and the sub-ring frame against the JAX package's.

tests/test_multichip.py's scene (64 x 128, 4,096 slots, 256 spawns a
frame, bin capacity 128) runs 3 frames on gloo meshes of 2 and 4 ranks
(rank bodies in torch_mesh_ranks.py, which imports no jax), with the
global spawn ring and with one sub-ring a rank, and the full-family frame
(2 lights) for 2 frames. Every rank's band, stitched, and its shard of the
particles are held to the single-process frame from the same generator
draws with that test's bounds: uint8 within 1, positions within 1e-5
relative / 1e-4 absolute, avg_lum within 1e-4. The single-process
sub-ring frame is held to the JAX sub-ring frame with the JAX draws
injected (tests/test_torch_flagship.py's bounds)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from illuminant_tpu.scenes import build_flagship as jax_build_flagship
from illuminant_tpu_torch.entry import dryrun_multichip, entry
from illuminant_tpu_torch.parallel import mesh as pmesh
from illuminant_tpu_torch.scenes import build_flagship
from test_torch_flagship import _jax_uniforms

import torch_mesh_ranks

torch.set_num_threads(1)

SCENE_KW = dict(height=64, width=128, capacity=1 << 12, spawn_max=256,
                bin_capacity=128)
COUNT = 128
SEED = 7


def _runs(d):
    """run name -> (build_flagship kwargs, frames, first ring cursor). The
    global ring's windows start 64 slots before the middle of the ring,
    so that they cross from one rank's shard into the next."""
    mid = SCENE_KW["capacity"] // 2 - 64
    return {"global_ring": (dict(SCENE_KW, n_lights=4), 3, mid),
            "sub_rings": (dict(SCENE_KW, n_lights=4, spawn_sub_rings=d), 3,
                          0),
            "full_family": (dict(SCENE_KW, n_lights=2, full_family=True), 2,
                            mid)}


def _single(kw, frames, cursor):
    """The single-process frames -> (images, final positions, avg_lum per
    frame, dropped per frame)."""
    scene = build_flagship(device="cpu", **kw)
    state = scene.system.state.replace(
        write_cursor=torch.tensor(cursor, dtype=torch.int32))
    gen = torch.Generator().manual_seed(SEED)
    avg = torch.tensor(0.5)
    env_u = scene.environment.uniforms(device="cpu")
    imgs, avgs, drops = [], [], []
    for i in range(frames):
        img, state, avg, dropped = scene.frame(
            state, avg, gen, scene.volume, scene.gbuffer,
            scene.sphere_lights, env_u, COUNT, frame_index=i)
        imgs.append(img)
        avgs.append(float(avg))
        drops.append(int(dropped))
    return imgs, state.position, avgs, drops


@pytest.fixture(scope="module")
def mesh_runs():
    out = {}
    for d in (2, 4):
        runs = _runs(d)
        ranks = pmesh.spawn_ranks(
            torch_mesh_ranks.mesh_frames, d,
            [(kw, frames, COUNT, SEED, cursor)
             for kw, frames, cursor in runs.values()],
            device="cpu")
        for j, name in enumerate(runs):
            out[d, name] = ([r[j] for r in ranks], _single(*runs[name]))
    return out


@pytest.mark.parametrize("name", ["global_ring", "sub_rings", "full_family"])
@pytest.mark.parametrize("d", [2, 4])
def test_mesh_frame_matches_single_process(mesh_runs, d, name):
    ranks, (imgs, pos, avgs, drops) = mesh_runs[d, name]
    assert [r[4] for r in ranks] == [
        pmesh.band_rows(build_flagship(device="cpu", **_runs(d)[name][0])
                        .raster_config, d, r) for r in range(d)]
    for i, img in enumerate(imgs):
        bands = torch.cat([r[0][i] for r in ranks])
        assert bands.shape == img.shape and bands.dtype == torch.uint8
        diff = (bands.to(torch.int32) - img.to(torch.int32)).abs()
        assert int(diff.max()) <= 1, int(diff.max())
        for r in ranks:
            assert abs(r[2][i] - avgs[i]) < 1e-4, (r[2][i], avgs[i])
            assert r[3][i] == drops[i] == 0
    np.testing.assert_allclose(torch.cat([r[1] for r in ranks]).numpy(),
                               pos.numpy(), rtol=1e-5, atol=1e-4)
    assert int((pos[:, 3] > 0).sum()) > 0
    # shard_gbuffer: each rank's rows of the G-buffer, placed in the frame.
    whole = build_flagship(device="cpu", **_runs(d)[name][0]).gbuffer
    for r in ranks:
        (row0, row1), (world, origin) = r[4], r[5]
        assert origin.tolist() == [0.0, float(row0)]
        assert torch.equal(world, whole.world_position()[row0:row1])


@pytest.fixture(scope="module")
def sub_ring_frames():
    """The single-process frame with 4 sub-rings and the JAX one, 3
    frames from empty states with the JAX draws."""
    kw = dict(SCENE_KW, n_lights=4, spawn_sub_rings=4)
    sj = jax_build_flagship(**kw)
    st = build_flagship(device="cpu", **kw)
    key = jax.random.key(SEED)
    out = {"jax": [], "port": []}
    state = jax.tree.map(jnp.copy, sj.system.state)
    avg = jnp.float32(0.5)
    for i in range(3):
        img, state, avg, _ = sj.frame(
            state, avg, key, sj.volume, sj.gbuffer, sj.sphere_lights,
            sj.environment.uniforms(), jnp.asarray(COUNT, jnp.int32),
            frame_index=i)
        out["jax"].append((np.asarray(img), np.asarray(state.position),
                           float(avg)))
    state, avg = st.system.state, torch.tensor(0.5)
    env_u = st.environment.uniforms(device="cpu")
    for i in range(3):
        img, state, avg, _ = st.frame(
            state, avg, None, st.volume, st.gbuffer, st.sphere_lights, env_u,
            COUNT, frame_index=i,
            spawn_uniforms=_jax_uniforms(key, i, st.spawner.spawn_max))
        out["port"].append((img.numpy(), state.position.numpy().copy(),
                            float(avg)))
    return out


@pytest.mark.parametrize("i", [0, 1, 2])
def test_sub_ring_frame_matches_jax(sub_ring_frames, i):
    """Each of 4 segments takes 32 of the 128 spawns a frame at its own
    cursor: live masks equal the JAX frame's; positions, the image and
    avg_lum within tests/test_torch_flagship.py's bounds."""
    (ti, tp, ta), (ji, jp, ja) = (sub_ring_frames[k][i]
                                  for k in ("port", "jax"))
    live = jp[:, 3] > 0
    np.testing.assert_array_equal(tp[:, 3] > 0, live)
    assert live.reshape(4, -1).sum(axis=1).tolist() == [32 * (i + 1)] * 4
    err = np.linalg.norm(tp[live, :3] - jp[live, :3], axis=-1)
    assert (err <= 0.05).mean() >= 0.99, np.sort(err)[-5:]
    d = np.abs(ti.astype(np.int32) - ji.astype(np.int32))
    assert d.mean() <= 1.0 and (d > 8).mean() <= 0.01, d.mean()
    assert abs(ta - ja) <= 0.01 * abs(ja), (ta, ja)


def test_entry_runs_on_the_cpu():
    fn, args = entry(device="cpu")
    img, state, avg, dropped = fn(*args)
    assert img.shape == (128, 256, 3) and img.dtype == torch.uint8
    assert int((state.position[:, 3] > 0).sum()) == 128
    assert np.isfinite(float(avg)) and int(dropped) == 0


def test_dryrun_multichip_on_gloo():
    """Two ranks: the 32-row frame is one tile row, so rank 1 owns no
    rows; both agree on the gathered frame."""
    dryrun_multichip(2, device="cpu")
