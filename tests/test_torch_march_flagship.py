"""The flagship frame with `shadow_mode="march"`: the PyTorch port
against the JAX package.

As in tests/test_torch_family_flagship.py, both packages build the
flagship at a small size, start from the same (JAX-built) particle state
carried over through `core.interop`, and run frames 0, 1, 2, the port
with the JAX frame's own spawn draws (ROADMAP F-watch 1), on the analytic
and the voxel field, without and with the extra light families. Under
the march the sphere lights and the sun take the exact cone march (on
the card K12; here its plain loop), the line light its own scan and the
volumetric light its windowed scan, as in the JAX frame
(scenes.py:604, 683, 731-744). Each JAX frame is built and run once per
module.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from illuminant_tpu.scenes import build_flagship as jax_build_flagship
from illuminant_tpu_torch.core import interop
from illuminant_tpu_torch.particles.state import ParticleState
from illuminant_tpu_torch.scenes import build_flagship
from test_torch_columns import sampler_rounding_like_jax
from test_torch_flagship import _frame_out, _jax_uniforms

torch.set_num_threads(1)

KW = dict(height=96, width=160, capacity=1 << 10, spawn_max=128, n_lights=4,
          sdf_resolution_scale=0.5, preset="fast", shadow_mode="march")
SPAWN_COUNT = 64
N_FRAMES = 3
RUNS = {
    "analytic": dict(field="analytic"),
    "analytic_family": dict(field="analytic", full_family=True),
    "voxel": dict(field="voxel"),
    "voxel_family": dict(field="voxel", full_family=True),
}


def _run_frames(run):
    """{"jax", "port"} -> per-frame outputs as numpy."""
    kw = {**KW, **RUNS[run]}
    sj = jax_build_flagship(**kw)
    st = build_flagship(device="cpu", **kw)
    key = jax.random.key(0)
    state0 = interop.as_numpy_fields(sj.system.state)
    draws = [_jax_uniforms(key, i, sj.spawner.spawn_max)
             for i in range(N_FRAMES)]

    out = {"jax": [], "port": []}
    state = jax.tree.map(jnp.copy, sj.system.state)
    avg = jnp.float32(0.5)
    env_j = sj.environment.uniforms()
    for i in range(N_FRAMES):
        img, state, avg, drops = sj.frame(
            state, avg, key, sj.volume, sj.gbuffer, sj.sphere_lights, env_j,
            jnp.asarray(SPAWN_COUNT, jnp.int32), frame_index=i)
        out["jax"].append(_frame_out(img, state, avg, drops))

    # The JAX column-map sampler rounds its maps to bf16; the port
    # reproduces that here (the collision and the march on the ColumnField).
    rounding = sampler_rounding_like_jax() if run.startswith("voxel") \
        else contextlib.nullcontext()
    with rounding:
        state = interop.to_torch(ParticleState, state0)
        avg = torch.tensor(0.5)
        env_t = st.environment.uniforms(device="cpu")
        for i in range(N_FRAMES):
            img, state, avg, drops = st.frame(
                state, avg, None, st.volume, st.gbuffer, st.sphere_lights,
                env_t, SPAWN_COUNT, frame_index=i, spawn_uniforms=draws[i])
            out["port"].append(_frame_out(img, state, avg, drops))
    return out


@pytest.fixture(scope="module")
def frames():
    return {run: _run_frames(run) for run in RUNS}


CASES = [(run, i) for run in RUNS for i in range(N_FRAMES)]


@pytest.mark.parametrize("run,i", CASES)
def test_frame_image_matches_jax(frames, run, i):
    t, j = frames[run]["port"][i], frames[run]["jax"][i]
    assert t["img"].shape == j["img"].shape == (96, 160, 3)
    assert t["img"].dtype == np.uint8
    d = np.abs(t["img"].astype(np.int32) - j["img"].astype(np.int32))
    # tests/test_torch_family_flagship.py's bounds: mean |d| <= 1 LSB and
    # at most 1% of values off by more than 8 (measured mean 0.10-0.23,
    # > 8 at most 0.1%).
    assert d.mean() <= 1.0, d.mean()
    assert (d > 8).mean() <= 0.01, (d > 8).mean()
    assert t["img"].astype(np.float64).var() > 0.0
    assert t["drops"] == 0 and j["drops"] == 0


@pytest.mark.parametrize("run,i", CASES)
def test_frame_avg_lum_matches_jax(frames, run, i):
    t, j = frames[run]["port"][i], frames[run]["jax"][i]
    # The smoothed 95th percentile of the same bf16 HDR histogram: within
    # 1% relative (measured at most 1.0e-4 relative).
    assert np.isfinite(t["avg"])
    assert abs(t["avg"] - j["avg"]) <= 0.01 * abs(j["avg"]), (t["avg"],
                                                               j["avg"])


@pytest.mark.parametrize("run,i", CASES)
def test_frame_particles_match_jax(frames, run, i):
    t, j = frames[run]["port"][i], frames[run]["jax"][i]
    live_t = t["pos"][:, 3] > 0
    live_j = j["pos"][:, 3] > 0
    assert live_t.sum() == live_j.sum() == SPAWN_COUNT * (i + 1)
    np.testing.assert_array_equal(live_t, live_j)
    err = np.linalg.norm(t["pos"][live_t, :3] - j["pos"][live_j, :3],
                         axis=-1)
    # The shadows do not move the particles: the family test's bounds.
    assert err.max() <= 0.05, np.sort(err)[-5:]
    assert (err <= 1e-3).mean() >= 0.999, np.sort(err)[-5:]


@pytest.mark.parametrize("field", ["analytic", "voxel"])
def test_march_differs_from_scan(frames, field):
    """The march is in the frame: the port's march image differs from its
    scan image of the same frame, and both from no shadows at all."""
    def image(shadow_mode):
        st = build_flagship(device="cpu", **{**KW, "field": field,
                                             "shadow_mode": shadow_mode})
        img, *_ = st.frame_loop(
            st.system.state, torch.tensor(0.5),
            torch.Generator().manual_seed(0), st.volume, st.gbuffer,
            st.sphere_lights, st.environment.uniforms(device="cpu"),
            SPAWN_COUNT, 0, 1)
        return img.numpy().astype(np.int32)

    march, scan, none = image("march"), image("scan"), image("none")
    assert np.abs(march - scan).mean() > 0.0
    assert np.abs(march - none).mean() > 0.5
