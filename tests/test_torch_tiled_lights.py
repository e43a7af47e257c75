"""Tiled light culling (lighting/tiled_lights.py) and the particle lights'
tiled and auto routes in the port, against the JAX package.

The cases mirror tests/test_tiled_lights.py: the same numpy inputs go
through both packages on the CPU, where the port's K10 wrapper runs its
plain version. Tolerances:
  * the bins (`mask`, `dropped`) exactly equal, `idx` equal under the
    mask: the port enumerates candidates in the JAX order and sorts them
    stably;
  * the image within 2^-8 x max + 1e-3: the JAX package contracts the
    opacities with the colours from bfloat16 operands (8 bits of
    mantissa), the port sums in float32;
  * `window_deficit_px` to 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from illuminant_tpu.core.config import QualitySettings as JQuality
from illuminant_tpu.lighting import environment as jenv
from illuminant_tpu.lighting import gbuffer as jgbuf
from illuminant_tpu.lighting import particle_light as jpl
from illuminant_tpu.lighting import tiled_lights as jtl
from illuminant_tpu.particles.state import ParticleState as JParticleState
from illuminant_tpu.sdf.analytic import pack_scene as jpack_scene
from illuminant_tpu_torch.core.config import QualitySettings
from illuminant_tpu_torch.lighting import environment as tenv
from illuminant_tpu_torch.lighting import gbuffer as tgbuf
from illuminant_tpu_torch.lighting import particle_light as tpl
from illuminant_tpu_torch.lighting import tiled_lights as ttl
from illuminant_tpu_torch.particles.state import ParticleState
from illuminant_tpu_torch.sdf.analytic import pack_scene

CPU = torch.device("cpu")
BF16_REL = 2.0 ** -8


def _close_to_jax(port, ref):
    """|port - ref| <= 2^-8 x max|ref| + 1e-3 (the bf16 contraction)."""
    port = np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    err = float(np.abs(port - ref).max())
    tol = BF16_REL * float(np.abs(ref).max()) + 1e-3
    assert err <= tol, (err, tol)
    assert float(np.abs(ref).max()) > 0.0


class Case:
    """One scene in both packages: environment, G-buffer, particle state,
    field (None or a list of obstructions)."""

    def __init__(self, n=96, h=96, w=160, seed=3, obstructions=None,
                 relative_y=None, fullbright=None):
        rng = np.random.default_rng(seed)
        pos = np.zeros((n, 4), np.float32)
        pos[:, 0] = rng.uniform(-10, w + 10, n)  # some off-screen
        pos[:, 1] = rng.uniform(-10, h + 10, n)
        pos[:, 2] = rng.uniform(4, 20, n)
        pos[:, 3] = (rng.uniform(0, 1, n) > 0.2).astype(np.float32)
        col = np.ones((n, 4), np.float32)
        col[:, :3] = rng.uniform(0.2, 1.0, (n, 3))
        col[:, 3] = rng.uniform(0.5, 1.0, n)
        self.pos, self.col = pos, col

        jenv_ = jenv.LightingEnvironment(ground_z=0.0, maximum_z=64.0)
        tenv_ = tenv.LightingEnvironment(ground_z=0.0, maximum_z=64.0)
        self.jenv, self.tenv = jenv_.uniforms(), tenv_.uniforms(device=CPU)
        jgb = jgbuf.flat_ground(h, w, self.jenv)
        tgb = tgbuf.flat_ground(h, w, self.tenv)
        for name, plane in (("relative_y", relative_y),
                            ("fullbright", fullbright)):
            if plane is not None:
                jgb = jgb.replace(**{name: jnp.asarray(plane)})
                tgb = tgb.replace(**{name: torch.as_tensor(plane)})
        self.jgb, self.tgb = jgb, tgb
        self.jstate = JParticleState.empty(n).replace(
            position=jnp.asarray(pos), color=jnp.asarray(col))
        self.tstate = ParticleState.empty(n, device=CPU).replace(
            position=torch.as_tensor(pos), color=torch.as_tensor(col))
        if obstructions is None:
            self.jfield, self.tfield = jpack_scene([]), pack_scene(
                [], device=CPU)
        else:
            self.jfield = jpack_scene([jenv.LightObstruction.box(*o)
                                       for o in obstructions])
            self.tfield = pack_scene([tenv.LightObstruction.box(*o)
                                      for o in obstructions], device=CPU)

    def jax(self, **kw):
        return np.asarray(jpl.accumulate_particle_lights(
            self.jfield, self.jgb, self.jstate,
            jpl.ParticleLightSource(**kw), self.jenv, JQuality()))

    def port(self, **kw):
        template = kw.pop("template")
        return tpl.accumulate_particle_lights(
            self.tfield, self.tgb, self.tstate,
            tpl.ParticleLightSource(template=_port_template(template), **kw),
            self.tenv, QualitySettings()).numpy()


def _port_template(j):
    """The port's SphereLightSource with the JAX one's fields."""
    import dataclasses

    return tenv.SphereLightSource(**{
        f.name: getattr(j, f.name) for f in dataclasses.fields(j)})


def _template(**kw):
    base = dict(radius=2.0, ramp_length=24.0, color=(1.0, 0.9, 0.8, 0.06),
                cast_shadows=False)
    base.update(kw)
    return jenv.SphereLightSource(**base)


def _both(case, **kw):
    return case.port(**kw), case.jax(**kw)


def test_tiled_matches_dense_full_evaluation():
    """The tiled route against the JAX package's, and against the port's
    own dense subset evaluation to the JAX test's 0.02 relative."""
    case = Case()
    template = _template()
    port, ref = _both(case, template=template, method="tiled", tile=32,
                      tile_capacity=64)
    _close_to_jax(port, ref)
    dense = case.port(template=template, max_lights=case.pos.shape[0],
                      method="subset")
    assert np.abs(port - dense).max() / max(dense.max(), 1e-6) < 0.02


@pytest.mark.parametrize("capacity,route", [(104, "tiled"), (64, "subset")])
def test_auto_method_picks_tiled_for_shadowless(capacity, route):
    """96 shadowless lights over 96 x 160: the density estimate (67.6
    binned a tile, x 1.5) fits a capacity of 104, and auto equals the
    tiled route bit for bit; at 64 it takes the subset, as the JAX
    package does."""
    case = Case()
    template = _template(ramp_length=18.0, color=(1.0, 1.0, 1.0, 0.05))
    auto, ref = _both(case, template=template, tile_capacity=capacity)
    forced = case.port(template=template, method=route,
                       tile_capacity=capacity)
    assert np.array_equal(auto, forced)
    _close_to_jax(auto, ref)


def _bins_equal(port, ref):
    idx, mask, dropped = (t.numpy() for t in port)
    jidx, jmask, jdropped = (np.asarray(a) for a in ref)
    assert idx.dtype == np.int32 and mask.dtype == bool
    assert int(dropped) == int(jdropped)
    assert np.array_equal(mask, jmask)
    assert np.array_equal(np.where(mask, idx, -1), np.where(jmask, jidx, -1))


@pytest.mark.parametrize("window", [False, True])
def test_binning_matches_jax(window):
    """Random lights over and past a 3 x 5 grid of 32 px tiles; with
    `window`, per-tile y bounds widened by relief, a y support of its own
    and the extra candidate window."""
    rng = np.random.default_rng(7)
    n, tile, th, tw = 50, 32, 3, 5
    x = rng.uniform(-20, tw * 32 + 20, n).astype(np.float32)
    y = rng.uniform(-20, th * 32 + 20, n).astype(np.float32)
    live = rng.uniform(0, 1, n) > 0.3
    kw = {}
    if window:
        ty0 = (np.arange(th * tw) // tw * tile).astype(np.float32)
        lo = ty0 - rng.uniform(0, 40, th * tw).astype(np.float32)
        hi = ty0 + tile + rng.uniform(0, 8, th * tw).astype(np.float32)
        kw = dict(influence_y=25.5, extra_y_window=40.0)
        jkw = dict(kw, tile_y_lo=jnp.asarray(lo), tile_y_hi=jnp.asarray(hi))
        tkw = dict(kw, tile_y_lo=torch.as_tensor(lo),
                   tile_y_hi=torch.as_tensor(hi))
    else:
        jkw = tkw = kw
    ref = jtl.bin_lights_to_tiles(jnp.asarray(x), jnp.asarray(y),
                                  jnp.asarray(live), 40.0, tile, th, tw,
                                  capacity=64, **jkw)
    port = ttl.bin_lights_to_tiles(torch.as_tensor(x), torch.as_tensor(y),
                                   torch.as_tensor(live), 40.0, tile, th, tw,
                                   capacity=64, **tkw)
    _bins_equal(port, ref)
    assert int(port[2]) == 0


def test_capacity_overflow_reported():
    """80 co-located lights and 40 more around them against capacity 16:
    the same 16 kept a tile (the stable sort), the same overflow."""
    rng = np.random.default_rng(1)
    x = np.concatenate([np.full(80, 16.0), rng.uniform(0, 64, 40)])
    y = np.concatenate([np.full(80, 16.0), rng.uniform(0, 64, 40)])
    x, y = x.astype(np.float32), y.astype(np.float32)
    live = np.ones(120, bool)
    ref = jtl.bin_lights_to_tiles(jnp.asarray(x), jnp.asarray(y),
                                  jnp.asarray(live), 8.0, 32, 2, 2,
                                  capacity=16)
    port = ttl.bin_lights_to_tiles(torch.as_tensor(x), torch.as_tensor(y),
                                   torch.as_tensor(live), 8.0, 32, 2, 2,
                                   capacity=16)
    _bins_equal(port, ref)
    assert int(port[2]) > 80 - 16


def test_tiled_respects_fullbright_and_ao_parity():
    """An obstruction field, an AO template and a fullbright band."""
    fullbright = np.zeros((96, 160), np.float32)
    fullbright[:, 100:112] = 1.0
    case = Case(seed=11, obstructions=[((60.0, 40.0, 8.0),
                                              (10.0, 10.0, 8.0))],
                fullbright=fullbright)
    template = _template(ramp_length=20.0, color=(0.9, 0.9, 1.0, 0.06),
                         ambient_occlusion_radius=4.0,
                         ambient_occlusion_opacity=0.7)
    port, ref = _both(case, template=template, method="tiled", tile=32,
                      tile_capacity=64)
    _close_to_jax(port, ref)
    assert np.abs(port[:, 100:112]).max() == 0.0


def test_tiled_covers_elevated_pixels():
    rel = np.zeros((96, 160), np.float32)
    rel[64:, :] = -28.0
    case = Case(seed=5, relative_y=rel)
    template = _template(ramp_length=20.0, color=(1.0, 1.0, 1.0, 0.08))
    port, ref = _both(case, template=template, method="tiled", tile=32,
                      tile_capacity=64)
    _close_to_jax(port, ref)


def test_tiled_covers_squashed_y_falloff():
    case = Case(seed=9)
    template = _template(ramp_length=16.0, color=(1.0, 1.0, 1.0, 0.1),
                         falloff_y_factor=0.4)
    port, ref = _both(case, template=template, method="tiled", tile=32,
                      tile_capacity=64)
    _close_to_jax(port, ref)


@pytest.mark.parametrize("method", ["subset", "tiled"])
def test_stipple_energy_consistent_across_paths(method):
    case = Case(seed=13)
    template = _template(ramp_length=22.0, color=(1.0, 1.0, 1.0, 0.06))
    port, ref = _both(case, template=template, stipple_factor=0.5,
                      max_lights=96, method=method, tile=32,
                      tile_capacity=64)
    _close_to_jax(port, ref)


def test_auto_density_gate_routes_dense_washes_to_subset():
    case = Case(w=64)
    template = _template(ramp_length=40.0, color=(1.0, 1.0, 1.0, 0.05))
    auto, ref = _both(case, template=template)
    subset = case.port(template=template, method="subset")
    assert np.array_equal(auto, subset)
    _close_to_jax(auto, ref)


def test_auto_with_ramp_texture_takes_the_subset():
    """A shadowless template with a ramp texture: the JAX auto route takes
    the strided subset, and so does the port's."""
    case = Case()
    ramp = np.linspace(0.2, 1.0, 8 * 3, dtype=np.float32).reshape(1, 8, 3)
    template = _template(ramp_length=18.0, color=(1.0, 1.0, 1.0, 0.05),
                         ramp_texture=ramp)
    auto, ref = _both(case, template=template)
    assert np.array_equal(ref, case.jax(template=template, method="subset"))
    assert np.array_equal(auto, case.port(template=template,
                                          method="subset"))
    _close_to_jax(auto, ref)


def test_window_deficit_reported():
    env_j = jenv.LightingEnvironment().uniforms()
    env_t = tenv.LightingEnvironment().uniforms(device=CPU)
    rel = np.full((96, 160), -150.0, np.float32)
    jgb = jgbuf.flat_ground(96, 160, env_j).replace(
        relative_y=jnp.asarray(rel))
    tgb = tgbuf.flat_ground(96, 160, env_t).replace(
        relative_y=torch.as_tensor(rel))
    template = _template(ramp_length=10.0, color=(1.0, 1.0, 1.0, 1.0))
    pos = np.zeros((8, 4), np.float32)
    pos[:, 3] = 1.0
    col = np.ones((8, 4), np.float32)
    for mry, expect_deficit in ((32.0, True), (200.0, False)):
        _, jdiag = jtl.accumulate_sphere_lights_tiled(
            None, jgb, jnp.asarray(pos), jnp.asarray(col),
            jnp.ones((8,), bool), template, env_j, tile=32, capacity=8,
            max_relative_y=mry)
        img, diag = ttl.accumulate_sphere_lights_tiled(
            None, tgb, torch.as_tensor(pos), torch.as_tensor(col),
            torch.ones(8, dtype=torch.bool), _port_template(template),
            env_t, tile=32, capacity=8, max_relative_y=mry)
        got = float(diag["window_deficit_px"])
        assert abs(got - float(jdiag["window_deficit_px"])) <= 1e-6
        assert (got > 100.0) == expect_deficit
        assert int(diag["dropped"]) == int(jdiag["dropped"])
        assert img.shape == (96, 160, 4)


def test_return_diagnostics_gives_the_tiled_dropped():
    """`return_diagnostics` returns the tiled route's overflow count: 40
    lights piled on one spot against a capacity of 8."""
    case = Case()
    case.pos[:, :2] = 50.0
    case.pos[:, 3] = 1.0
    case.tstate = case.tstate.replace(position=torch.as_tensor(case.pos))
    case.jstate = case.jstate.replace(position=jnp.asarray(case.pos))
    template = _template()
    src = dict(method="tiled", tile=32, tile_capacity=8)
    _, dropped = tpl.accumulate_particle_lights(
        case.tfield, case.tgb, case.tstate,
        tpl.ParticleLightSource(template=_port_template(template), **src),
        case.tenv, QualitySettings(), return_diagnostics=True)
    _, jdropped = jpl.accumulate_particle_lights(
        case.jfield, case.jgb, case.jstate,
        jpl.ParticleLightSource(template=template, **src), case.jenv,
        JQuality(), return_diagnostics=True)
    assert int(dropped) == int(jdropped) > 0
