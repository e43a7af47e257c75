"""The port's spawners against the JAX package's: the host rate stream
(the same seeded numpy draws), the uniforms, and the device spawns with
the JAX draws injected. Spawned rows: 1e-5 relative / 1e-4 absolute (the
same float32 formula chain; sin / cos may differ by an ulp)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from illuminant_tpu.particles import formula as jf
from illuminant_tpu.particles import spawner as jspawner
from illuminant_tpu.particles.state import ParticleState as JState
from illuminant_tpu_torch.core import interop
from illuminant_tpu_torch.particles import formula as tf
from illuminant_tpu_torch.particles import spawner
from illuminant_tpu_torch.particles.state import ParticleState

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-4)


def _state(n, cursor=0, total=0, seed=0):
    rng = np.random.default_rng(seed)
    pos = np.zeros((n, 4), np.float32)
    pos[:, :3] = rng.uniform(0, 100, (n, 3))
    pos[:, 3] = np.where(rng.uniform(size=n) < 0.6,
                         rng.uniform(0.01, 3.0, n), 0.0)
    vel = rng.normal(0, 10, (n, 4)).astype(np.float32)
    color = rng.uniform(0, 1, (n, 4)).astype(np.float32)
    z = np.zeros((n, 4), np.float32)
    return dict(position=pos, velocity=vel, color=color, render_color=z,
                render_data=z, write_cursor=np.asarray(cursor, np.int32),
                total_spawned=np.asarray(total, np.int32))


def _jstate(d):
    return JState(**{k: jnp.asarray(v) for k, v in d.items()})


def _tstate(d):
    return interop.to_torch(ParticleState, d)


def _draws(key, spawn_max):
    """The JAX spawn's own random1..3 (spawner.py:108-111)."""
    return [np.asarray(jax.random.uniform(k, (spawn_max, 4), jnp.float32))
            for k in jax.random.split(key, 3)]


def _assert_rows(out_t, out_j):
    for name in ("position", "velocity", "color"):
        np.testing.assert_allclose(getattr(out_t, name).numpy(),
                                   np.asarray(getattr(out_j, name)),
                                   err_msg=name, **TOL)
    assert int(out_t.write_cursor) == int(out_j.write_cursor)
    assert int(out_t.total_spawned) == int(out_j.total_spawned)


def _spawner(mod, f, **kw):
    args = dict(min_rate=300.0, max_rate=5000.0,
                life=f.Formula1(constant=2.5, random_scale=1.0, offset=-0.5),
                position=f.Formula3(constant=(50.0, 40.0, 5.0),
                                    offset=(20.0, 10.0, 1.0),
                                    random_scale=(5.0, 5.0, 1.0),
                                    type=f.FORMULA_SPHERICAL),
                velocity=f.Formula3.unit_normal(30.0),
                color=f.Formula4(constant=(0.4, 0.5, 0.9, 0.5),
                                 random_scale=(0.4, 0.3, 0.1, 0.3)),
                spawn_max=48, seed=5)
    args.update(kw)
    return getattr(mod, args.pop("cls", "Spawner"))(**args)


RATE_CASES = {
    "stochastic": dict(),
    "maximum_total": dict(maximum_total=700),
    "count_scale": dict(additional_positions=[(10.0, 0.0, 0.0),
                                              (20.0, 5.0, 0.0)],
                        polygon_loop=True),
    "over_spawn_max": dict(min_rate=4000.0, max_rate=9000.0),
    "per_emitter_off": dict(additional_positions=[(1.0, 1.0, 1.0)],
                            rate_per_position=False),
    "feedback_instances": dict(cls="FeedbackSpawner", instance_multiplier=3),
}


@pytest.mark.parametrize("case", sorted(RATE_CASES))
def test_begin_tick_counts_match_jax(case):
    """60 ticks of stochastic rates (and dt changes) count as the JAX
    spawner does, with the same error carry and totals."""
    js = _spawner(jspawner, jf, **RATE_CASES[case])
    ts = _spawner(spawner, tf, **RATE_CASES[case])
    assert ts.count_scale() == js.count_scale()
    gran = 4 if case == "maximum_total" else 1
    counts = []
    for step in range(60):
        dt = 1.0 / 60 if step % 7 else 1.0 / 20
        c = ts.begin_tick(step * dt, dt, granularity=gran)
        assert c == js.begin_tick(step * dt, dt, granularity=gran)
        counts.append(c)
    assert ts.total_spawned == js.total_spawned and sum(counts) > 0
    assert ts.rate_error == pytest.approx(js.rate_error, abs=1e-9)
    assert ts.estimate_maximum_life(0.0) == js.estimate_maximum_life(0.0)


def test_reset_and_carry_runtime_from():
    a = _spawner(spawner, tf)
    first = [a.begin_tick(0.0, 1 / 60) for _ in range(12)]
    a.reset()
    assert a.total_spawned == 0 and a.rate_error == 0.0
    assert [a.begin_tick(0.0, 1 / 60) for _ in range(12)] == first
    b = _spawner(spawner, tf, min_rate=999.0)
    b.carry_runtime_from(a)
    assert (b.total_spawned, b.rate_error) == (a.total_spawned, a.rate_error)
    assert b._rng is a._rng
    fa = _spawner(spawner, tf, cls="FeedbackSpawner")
    fa.read_cursor = 17
    fb = _spawner(spawner, tf, cls="FeedbackSpawner")
    fb.carry_runtime_from(fa)
    assert fb.read_cursor == 17
    fb.reset()
    assert fb.read_cursor == 0


@pytest.mark.parametrize("case", ["polygon_open", "polygon_loop",
                                  "cycled_positions"])
def test_polygon_and_position_cycling_match_jax(case):
    """Polygon-path spawning (SpawnerCommon.fxh:136-177) and the cycling
    of additional positions, through the device spawn."""
    kw = dict(additional_positions=[(100.0, 0.0, 0.0), (100.0, 60.0, 4.0),
                                    (10.0, 50.0, 2.0)],
              velocity_along_polygon=None)
    if case != "cycled_positions":
        kw.update(polygon_rate=5.0, polygon_loop=case == "polygon_loop")
        kw["velocity_along_polygon"] = "vap"
    uj, ut = [], []
    for mod, f, out in ((jspawner, jf, uj), (spawner, tf, ut)):
        k = dict(kw)
        if k["velocity_along_polygon"]:
            k["velocity_along_polygon"] = f.Formula1(constant=20.0,
                                                     random_scale=4.0)
        out.append(_spawner(mod, f, **k))
    d = _state(256, cursor=100, total=123457)
    key = jax.random.key(11)
    out_j = jspawner.spawn(_jstate(d), uj[0].uniforms(0.0), jnp.asarray(40),
                           key, 48)
    out_t = spawner.spawn(_tstate(d), ut[0].uniforms(0.0), 40, 48,
                          uniforms=_draws(key, 48))
    _assert_rows(out_t, out_j)


@pytest.mark.parametrize("cursor,count", [(5, 200), (250, 37), (0, 256)])
def test_spawn_max_over_capacity_newest_wins(cursor, count):
    """A window longer than the ring writes each slot's newest row, as
    the JAX package's masked scatter does."""
    n, smax = 64, 256
    js = _spawner(jspawner, jf, spawn_max=smax)
    ts = _spawner(spawner, tf, spawn_max=smax)
    d = _state(n, cursor=cursor % n, total=cursor)
    key = jax.random.key(cursor)
    out_j = jspawner.spawn(_jstate(d), js.uniforms(0.0),
                           jnp.asarray(count), key, smax)
    out_t = spawner.spawn(_tstate(d), ts.uniforms(0.0), count, smax,
                          uniforms=_draws(key, smax))
    _assert_rows(out_t, out_j)
    # Two sub-rings: each segment's window (128 rows) overlaps its block
    # (32 slots), and again the newest row of each slot wins.
    out_j = jspawner.spawn(_jstate(d), js.uniforms(0.0),
                           jnp.asarray(count), key, smax, sub_rings=2)
    out_t = spawner.spawn(_tstate(d), ts.uniforms(0.0), count, smax,
                          uniforms=_draws(key, smax), sub_rings=2)
    _assert_rows(out_t, out_j)


FEEDBACK = dict(source_velocity_factor=0.5, source_life_min=0.2,
                source_life_max=2.5, multiply_life=True, instance_multiplier=2)


@pytest.mark.parametrize("source", ["foreign", "self"])
@pytest.mark.parametrize("count", [30, 48])
def test_spawn_feedback_matches_jax(source, count):
    js = _spawner(jspawner, jf, cls="FeedbackSpawner", **FEEDBACK)
    ts = _spawner(spawner, tf, cls="FeedbackSpawner", **FEEDBACK)
    js.read_cursor = ts.read_cursor = 90
    d = _state(128, cursor=60, total=60, seed=1)
    src = d if source == "self" else _state(192, seed=2)
    ju, tu = js.feedback_uniforms(0.5), ts.feedback_uniforms(0.5)
    for name, want in interop.as_numpy_fields(ju).items():
        if name != "base":
            np.testing.assert_array_equal(getattr(tu, name).numpy(), want)
    key = jax.random.key(3)
    jd = _jstate(d)
    out_j = jspawner.spawn_feedback(
        jd, jd if source == "self" else _jstate(src), ju, jnp.asarray(count),
        key, 48)
    td = _tstate(d)
    out_t = spawner.spawn_feedback(
        td, td if source == "self" else _tstate(src),
        interop.to_torch(spawner.FeedbackUniforms,
                         interop.as_numpy_fields(ju)),
        count, 48, uniforms=_draws(key, 48))
    _assert_rows(out_t, out_j)
    for s in (js, ts):
        s.advance_window(count, fallback_capacity=128)
    assert ts.read_cursor == js.read_cursor


def test_pattern_spawner_matches_jax():
    img = np.zeros((9, 7, 4), np.float32)
    img[::2, 1::3] = [0.9, 0.6, 1.4, 1.0]
    img[4, 4] = [0.1, 1.0, 0.2, 0.04]  # under the alpha threshold
    kw = dict(cls="PatternSpawner", image=img, pixel_scale=3.0, divisor=1,
              position=None)
    sp = []
    for mod, f in ((jspawner, jf), (spawner, tf)):
        sp.append(_spawner(mod, f, **{**kw, "position": f.Formula3(
            constant=(20.0, 10.0, 0.0))}))
    js, ts = sp
    assert ts.pattern_size == js.pattern_size == 9
    ju, tu = js.uniforms(0.0), ts.uniforms(0.0)
    for name, want in interop.as_numpy_fields(ju).items():
        np.testing.assert_array_equal(getattr(tu, name).numpy(), want,
                                      err_msg=name)
    d = _state(128, cursor=3, total=70)
    key = jax.random.key(4)
    out_j = jspawner.spawn(_jstate(d), ju, jnp.asarray(45), key, 48)
    out_t = spawner.spawn(_tstate(d), tu, 45, 48, uniforms=_draws(key, 48))
    _assert_rows(out_t, out_j)


def test_spawn_sub_rings_match_jax():
    """tests/test_multichip.py::test_spawn_sub_rings_unit through both
    packages with the JAX draws: 8 sub-rings of a 256-slot ring, 5 rows a
    segment at local cursor 0, then 3 more at the advanced cursor, and a
    count of 13 rounded down to 8. Every row equals the JAX spawn's."""
    D, cap, smax = 8, 256, 64
    kw = dict(life=None, position=None)
    js = _spawner(jspawner, jf, **{**kw, "life": jf.Formula1(constant=5.0),
                                   "position": jf.Formula3(
                                       constant=(1.0, 2.0, 3.0))})
    ts = _spawner(spawner, tf, **{**kw, "life": tf.Formula1(constant=5.0),
                                  "position": tf.Formula3(
                                      constant=(1.0, 2.0, 3.0))})
    key = jax.random.key(0)
    d = _state(cap)
    d["position"][:, 3] = 0.0
    sj, st = _jstate(d), _tstate(d)
    for count, k in ((40, key), (24, jax.random.fold_in(key, 1))):
        sj = jspawner.spawn(sj, js.uniforms(0.0), jnp.asarray(count), k,
                            smax, sub_rings=D)
        st = spawner.spawn(st, ts.uniforms(0.0), count, smax,
                           uniforms=_draws(k, smax), sub_rings=D)
        _assert_rows(st, sj)
    per_seg = (st.position[:, 3] > 0).reshape(D, cap // D).sum(dim=1)
    assert per_seg.tolist() == [8] * D
    d = _state(cap, cursor=48, total=48)
    out_j = jspawner.spawn(_jstate(d), js.uniforms(0.0), jnp.asarray(13),
                           key, smax, sub_rings=D)
    out_t = spawner.spawn(_tstate(d), ts.uniforms(0.0),
                          torch.tensor(13, dtype=torch.int32), smax,
                          uniforms=_draws(key, smax), sub_rings=D)
    _assert_rows(out_t, out_j)
    assert int(out_t.write_cursor) == 56


@pytest.mark.parametrize("n,smax,sub_rings,cursor,count", [
    (64, 48, 1, 40, 45),      # the global window crosses the shards
    (64, 48, 1, 60, 48),      # ... and the ring's end
    (64, 256, 1, 5, 200),     # a window longer than the ring
    (64, 48, 4, 12, 40),      # a sub-ring segment on each shard
    (64, 256, 4, 8, 256),     # segments longer than their blocks
])
@pytest.mark.parametrize("n_ranks", [2, 4])
def test_spawn_shards_write_their_slots(n, smax, sub_rings, cursor, count,
                                        n_ranks):
    """Each rank's spawn into its capacity shard (`shard=(rank, n_ranks)`)
    writes exactly the whole spawn's rows of its slots, and advances the
    ring's cursor and total as the whole spawn does."""
    ts = _spawner(spawner, tf, spawn_max=smax)
    d = _state(n, cursor=cursor, total=cursor + 7)
    draws = _draws(jax.random.key(cursor), smax)
    whole = spawner.spawn(_tstate(d), ts.uniforms(0.0), count, smax,
                          uniforms=draws, sub_rings=sub_rings)
    n_loc = n // n_ranks
    for r in range(n_ranks):
        part = {k: (v[r * n_loc:(r + 1) * n_loc] if v.ndim else v)
                for k, v in d.items()}
        out = spawner.spawn(_tstate(part), ts.uniforms(0.0), count, smax,
                            uniforms=draws, sub_rings=sub_rings,
                            shard=(r, n_ranks))
        for name in ("position", "velocity", "color"):
            np.testing.assert_array_equal(
                getattr(out, name).numpy(),
                getattr(whole, name)[r * n_loc:(r + 1) * n_loc].numpy(),
                err_msg=f"{name}, rank {r}")
        assert int(out.write_cursor) == int(whole.write_cursor)
        assert int(out.total_spawned) == int(whole.total_spawned)


@pytest.mark.parametrize("kw", [dict(sub_rings=3), dict(sub_rings=5),
                                dict(sub_rings=2, shard=(0, 4))])
def test_spawn_rejects_sub_rings_that_do_not_divide(kw):
    ts = _spawner(spawner, tf, spawn_max=48)
    d = _state(64 // kw.get("shard", (0, 1))[1])
    with pytest.raises(ValueError, match="sub_rings"):
        spawner.spawn(_tstate(d), ts.uniforms(0.0), 12, 48,
                      uniforms=_draws(jax.random.key(0), 48), **kw)
