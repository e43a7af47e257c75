"""ParticleSystem end to end in both packages: the systems that
`chip_smoke.py` runs (built by its own functions from either package's
classes), ticked 10 times with the JAX system's own spawn draws injected
into the port's, on no field (BASELINE config 2), on config 4's analytic
field and on a ColumnField; then the host API: update's accumulator,
reset, patch, live_count, auto_readback and render."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from illuminant_tpu.lighting import environment as jenv
from illuminant_tpu.ops import sdf_primitives as jprim
from illuminant_tpu.ops.bezier import pack_bezier as jpack
from illuminant_tpu.particles import formula as jformula
from illuminant_tpu.particles import render_data as jrd
from illuminant_tpu.particles import spawner as jspawner
from illuminant_tpu.particles import system as jsystem
from illuminant_tpu.particles import transforms as jtx
from illuminant_tpu.sdf import analytic as janalytic
from illuminant_tpu.sdf import columns as jcols
from illuminant_tpu.sdf import volume as jvol
from illuminant_tpu_torch.core import interop
from illuminant_tpu_torch.ops.noise import RandomField
from illuminant_tpu_torch.particles import system as tsystem
from illuminant_tpu_torch.sdf.columns import ColumnField
from test_torch_columns import sampler_rounding_like_jax

torch.set_num_threads(1)
H, W, CAP, SMAX = (cs.PARTICLE_SMALL[k] for k in
                   ("height", "width", "capacity", "spawn_max"))
TICKS = cs.PARTICLE_TICKS
FIELDS = ("position", "velocity", "color", "render_color", "render_data")


def jax_api():
    """The JAX package's classes under the names `chip_smoke.particle_api`
    gives the port's."""
    return SimpleNamespace(
        ParticleSystem=jsystem.ParticleSystem,
        ParticleSystemConfig=jsystem.ParticleSystemConfig,
        Spawner=jspawner.Spawner, FeedbackSpawner=jspawner.FeedbackSpawner,
        PatternSpawner=jspawner.PatternSpawner, formula=jformula, tx=jtx,
        RenderDataUniforms=jrd.RenderDataUniforms, pack_bezier=jpack,
        LightObstruction=jenv.LightObstruction,
        pack_scene=janalytic.pack_scene, TYPE_BOX=jprim.TYPE_BOX, kw={})


def jax_draws(system, tick):
    """The JAX system's draws at `tick` (system.py:270, :175;
    spawner.py:108-111): per spawner three (spawn_max, 4) arrays."""
    key = jax.random.fold_in(system._base_key, tick)
    out = []
    for i, s in enumerate(system.spawners):
        keys = jax.random.split(jax.random.fold_in(key, i), 3)
        out.append(tuple(np.asarray(jax.random.uniform(
            k, (s.spawn_max, 4), jnp.float32)) for k in keys))
    return out


def _column_fields():
    env = jenv.LightingEnvironment()
    env.obstructions += cs.config4_obstructions(jax_api(), H, W)
    cfg = jvol.SdfVolumeConfig(virtual_width=W, virtual_height=H,
                               virtual_depth=64, slice_count=16,
                               resolution_scale=0.5)
    cf_j = jcols.build_column_maps(jvol.generate_volume(
        cfg, env.pack_obstructions()))
    return cf_j, interop.to_torch(ColumnField, interop.as_numpy_fields(cf_j),
                                  device="cpu")


def _pair(case):
    """(JAX systems, port systems) of one case, in tick order."""
    japi, tapi = jax_api(), cs.particle_api("cpu")
    if case == "config2":
        return ([cs.config2_system(japi, H, W, CAP, SMAX)],
                [cs.config2_system(tapi, H, W, CAP, SMAX)])
    if case == "pattern_feedback":
        return (list(cs.pattern_feedback_systems(japi, H, W, CAP)),
                list(cs.pattern_feedback_systems(tapi, H, W, CAP)))
    if case == "config4_analytic":
        fj = japi.pack_scene(cs.config4_obstructions(japi, H, W))
        ft = tapi.pack_scene(cs.config4_obstructions(tapi, H, W), **tapi.kw)
        extra_j = extra_t = ()
    else:
        fj, ft = _column_fields()
        extra_j = cs.column_transforms(japi, H, W)
        extra_t = cs.column_transforms(tapi, H, W)
    js, _ = cs.config4_system(japi, fj, H, W, CAP, SMAX, extra=extra_j)
    ts, _ = cs.config4_system(tapi, ft, H, W, CAP, SMAX, extra=extra_t)
    return [js], [ts]


def _carry_random_fields(jsys, tsys):
    for j, t in zip(jsys, tsys):
        t.random_field = interop.to_torch(
            RandomField, interop.as_numpy_fields(j.random_field))


def _run(case, rounded=False):
    jsys, tsys = _pair(case)
    _carry_random_fields(jsys, tsys)
    for tick in range(TICKS):
        for j, t in zip(jsys, tsys):
            draws = jax_draws(j, tick)
            j.tick(cs.DT)
            if rounded:
                with sampler_rounding_like_jax():
                    t.tick(cs.DT, spawn_uniforms=draws)
            else:
                t.tick(cs.DT, spawn_uniforms=draws)
    return jsys, tsys


CASES = ("config2", "config4_analytic", "column_field", "pattern_feedback")


@pytest.fixture(scope="module")
def runs():
    out = {case: _run(case) for case in CASES}
    out["column_field_rounded"] = _run("column_field", rounded=True)
    return out


# Per case: the share of live particles whose state must agree to
# float32 rounding (1e-5 relative / 1e-4 absolute). Without a field, and
# with the ColumnField sampler rounded as XLA's, every particle takes the
# same path. On the analytic field XLA and PyTorch may round a distance
# differently by an ulp, which can flip a particle sitting on a collision
# threshold (measured: none flips). The unrounded ColumnField run samples
# float32 maps where the JAX package samples bf16 ones, which flips the
# outcome of some colliding particles (measured 98.3% agree).
AGREE = {"config2": 1.0, "pattern_feedback": 1.0,
         "column_field_rounded": 1.0, "config4_analytic": 0.99,
         "column_field": 0.95}


@pytest.mark.parametrize("case", sorted(AGREE))
def test_system_state_matches_jax(runs, case):
    jsys, tsys = runs[case]
    for j, t in zip(jsys, tsys):
        live_j = np.asarray(j.state.live_mask())
        np.testing.assert_array_equal(t.state.live_mask().numpy(), live_j)
        assert t.live_count == j.live_count > 0
        assert int(t.state.write_cursor) == int(j.state.write_cursor)
        assert int(t.state.total_spawned) == int(j.state.total_spawned)
        ok = np.ones(live_j.shape, bool)
        for name in FIELDS:
            a = getattr(t.state, name).numpy()
            b = np.asarray(getattr(j.state, name))
            ok &= np.all(np.abs(a - b) <= 1e-4 + 1e-5 * np.abs(b), axis=1)
        share = ok[live_j].mean()
        assert share >= AGREE[case], (case, share)


@pytest.mark.parametrize("case", ["config4_analytic", "column_field"])
def test_sensor_matches_jax(runs, case):
    jsys, tsys = runs[case]
    js = next(t for t in jsys[0].transforms if isinstance(t, jtx.Sensor))
    ts = next(t for t in tsys[0].transforms
              if isinstance(t, tsystem.tx.Sensor))
    assert abs(ts.measure(tsys[0].state) - js.measure(jsys[0].state)) <= \
        (0 if case == "config4_analytic" else 2)


def test_auto_readback_matches_jax(runs):
    jsys, tsys = runs["config2"]
    a = tsystem.auto_readback(tsys[0])
    b = jsystem.auto_readback(jsys[0])
    assert len(a.position) == tsys[0].live_count
    for name in ("position", "z", "size", "rotation", "color", "category"):
        np.testing.assert_allclose(getattr(a, name), getattr(b, name),
                                   rtol=1e-5, atol=1e-4, err_msg=name)
    assert np.all(np.diff(a.position[:, 1]) >= 0)


def test_render_matches_jax(runs):
    """`ParticleSystem.render` with the default untextured quads, to the
    bounds of tests/test_torch_raster.py for the JAX package's rgba8
    colours and 1/16-px positions."""
    from illuminant_tpu.raster.tiled import TiledRasterConfig as JCfg
    from illuminant_tpu_torch.raster.tiled import TiledRasterConfig

    jsys, tsys = runs["config2"]
    img_j, _ = jsys[0].render(JCfg(height=H, width=W, color_scale=2.0))
    img_t, diag = tsys[0].render(TiledRasterConfig(height=H, width=W))
    a, b = img_t.numpy().astype(np.float64), np.asarray(img_j, np.float64)
    assert diag["dropped"] == 0 and a.shape == b.shape == (H, W, 4)
    assert abs(a.sum() - b.sum()) / b.sum() < 0.02
    assert np.corrcoef(a.reshape(-1), b.reshape(-1))[0, 1] > 0.99


def _spawner_system(ups, seed=0):
    f = cs.particle_api("cpu").formula
    sp = tsystem.spawner_mod.Spawner(
        min_rate=100.0, max_rate=300.0, life=f.Formula1(constant=5.0),
        position=f.Formula3(constant=(10.0, 10.0, 0.0),
                            random_scale=(5.0, 5.0, 0.0)),
        velocity=f.Formula3(random_scale=(10.0, 10.0, 0.0)),
        spawn_max=32)
    cfg = tsystem.ParticleSystemConfig(capacity=256, updates_per_second=ups,
                                       life_decay_per_second=0.2)
    return tsystem.ParticleSystem(cfg, [sp], seed=seed, device="cpu")


@pytest.mark.parametrize("ups", [15.0, 60.0, 0.0])
def test_update_accumulator_matches_jax(ups):
    """The fixed-timestep accumulator ticks as often as the JAX one,
    with the same clamp of the incoming delta and the same carried error."""
    js = jsystem.ParticleSystem(jsystem.ParticleSystemConfig(
        capacity=64, updates_per_second=ups), [])
    ts = tsystem.ParticleSystem(tsystem.ParticleSystemConfig(
        capacity=64, updates_per_second=ups), [], device="cpu")
    deltas = [1 / 60, 1 / 144, 0.2, 1 / 30, 0.0, 1 / 61, 0.049] * 4
    ticks = []
    for d in deltas:
        ticks.append(ts.update(d))
        js.update(d)
        assert ts._tick_index == js._tick_index
        assert ts._update_error == pytest.approx(js._update_error)
        assert ts._time == pytest.approx(js._time)
    assert sum(ticks) == ts._tick_index > 0


def test_reset_reproduces_the_seeded_run():
    system = _spawner_system(0.0, seed=11)
    for _ in range(20):
        system.tick(cs.DT)
    first = system.state.position.clone()
    assert system.live_count > 0
    system.reset()
    assert system.live_count == 0 and system._tick_index == 0
    for _ in range(20):
        system.tick(cs.DT)
    assert torch.equal(first, system.state.position)


def test_patch_keeps_state_tick_and_spawner_runtime():
    system = _spawner_system(0.0)
    for _ in range(5):
        system.tick(cs.DT)
    before = system.state.position.clone()
    old = system.spawners[0]
    new = tsystem.spawner_mod.Spawner(min_rate=900.0, max_rate=900.0,
                                      spawn_max=32)
    grav = tsystem.tx.Gravity(attractors=[tsystem.tx.Attractor(
        position=(0.0, 0.0, 0.0), radius=50.0, strength=5.0)])
    system.patch(transforms=[new, grav],
                 config=tsystem.ParticleSystemConfig(
                     capacity=256, updates_per_second=0.0, friction=0.3))
    assert torch.equal(system.state.position, before)
    assert system._tick_index == 5 and system.config.friction == 0.3
    assert (new.total_spawned, new.rate_error) == (old.total_spawned,
                                                   old.rate_error)
    assert [type(s) for s, _ in system._step] == [tsystem.tx.Gravity]
    system.tick(cs.DT)
    assert system._tick_index == 6
    with pytest.raises(ValueError, match="structural"):
        system.patch(config=tsystem.ParticleSystemConfig(capacity=128))
    with pytest.raises(TypeError, match="unknown transform"):
        system.patch(transforms=[object()])


def test_subclassed_transforms_dispatch_as_their_base():
    class Pulsing(tsystem.tx.Gravity):
        pass

    system = _spawner_system(0.0)
    system.patch(transforms=system.transforms + [
        Pulsing(), tsystem.tx.GeometricTransform()])
    assert [f for _, f in system._step] == [
        tsystem.tx.apply_gravity, tsystem.tx.apply_matrix_multiply]
