"""ParticleSystem.Render of the port against the JAX package: the
additive route of `render_particles` for untextured particles, and the
exact scatter oracle (`splat_additive`, `rasterize_additive`)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from illuminant_tpu.particles.state import ParticleState as JState
from illuminant_tpu.raster import particles as jparticles
from illuminant_tpu.raster import render as jrender
from illuminant_tpu.raster import tiled as jtiled
from illuminant_tpu_torch.core import interop
from illuminant_tpu_torch.particles.state import ParticleState
from illuminant_tpu_torch.raster import particles, render, tiled

torch.set_num_threads(1)
H, W = 64, 96


def _state(n=500, seed=0):
    """Live and dead particles on the JAX payload's 1/16-px grid (z too,
    so that z_to_y = 1 keeps screen y on it), some off screen."""
    rng = np.random.default_rng(seed)
    pos = np.zeros((n, 4), np.float32)
    pos[:, 0] = np.round(rng.uniform(-3, W + 3, n) * 16) / 16
    pos[:, 1] = np.round(rng.uniform(-3, H + 3, n) * 16) / 16
    pos[:, 2] = np.round(rng.uniform(0, 6, n) * 16) / 16
    pos[:, 3] = np.where(rng.uniform(size=n) < 0.85, 1.0, 0.0)
    rc = rng.uniform(0.0, 1.5, (n, 4)).astype(np.float32)
    rd = np.zeros((n, 4), np.float32)
    rd[:, 0] = rng.uniform(1.0, 6.0, n)
    z = np.zeros((n, 4), np.float32)
    d = dict(position=pos, velocity=z, color=z, render_color=rc,
             render_data=rd, write_cursor=np.asarray(0, np.int32),
             total_spawned=np.asarray(0, np.int32))
    return (JState(**{k: jnp.asarray(v) for k, v in d.items()}),
            interop.to_torch(ParticleState, d))


def _rel(a, b, floor):
    return (np.abs(a - b) / np.maximum(np.abs(b), floor)).max()


CASES = {
    "quad": dict(),
    "round": dict(appearance="rounded"),
    "gauss": dict(appearance="glow"),
    "kernel_override": dict(appearance="kernel"),
    "z_to_y": dict(z_to_y=1.0),
    "size_from_z": dict(size_from_z=0.1),
    "stipple": dict(stipple_factor=0.5),
    "global_color": dict(global_color=(0.5, 1.0, 2.0, 1.0)),
    "background": dict(background="image"),
    "z_formula_additive": dict(z_formula=(0.0, 0.0, 1.0, 0.0)),
}


def _kwargs(mod, case):
    kw = dict(CASES[case])
    app = kw.pop("appearance", None)
    if app:
        kw["appearance"] = mod.ParticleAppearance(
            rounded=app == "rounded", glow=app == "glow",
            kernel="round" if app == "kernel" else None)
    if kw.get("background") == "image":
        kw["background"] = np.random.default_rng(1).uniform(
            0, 0.3, (H, W, 4)).astype(np.float32)
    return kw


@pytest.mark.parametrize("case", sorted(CASES))
def test_render_particles_matches_jax(case):
    js, ts = _state()
    ref, jdiag = jrender.render_particles(
        js, jtiled.TiledRasterConfig(height=H, width=W, bin_capacity=512,
                                     rgba8_colors=False),
        **_kwargs(jrender, case))
    out, diag = render.render_particles(
        ts, tiled.TiledRasterConfig(height=H, width=W),
        **_kwargs(render, case))
    assert int(jdiag["dropped"]) == 0 and diag["dropped"] == 0
    a, b = out.numpy().astype(np.float64), np.asarray(ref, np.float64)
    assert a.shape == b.shape == (H, W, 4)
    # tests/test_torch_raster.py::test_round_matches_jax_parity_preset's
    # bounds: the JAX side carries colours and coverage in bf16 through
    # its bins; the port is float32.
    assert _rel(a, b, 0.25) < 0.08, case
    assert abs(a.sum() - b.sum()) / b.sum() < 0.01, case


def test_untextured_additive_and_z_to_y():
    """tests/test_render_particles.py's untextured and z_to_y cases."""
    _, ts = _state(64)
    img, diag = render.render_particles(ts, tiled.TiledRasterConfig(
        height=H, width=W))
    assert diag["dropped"] == 0 and float(img.sum()) > 1.0
    one = ts.replace(position=torch.tensor([[32.0, 40.0, 10.0, 1.0]]),
                     render_color=torch.full((1, 4), 0.8),
                     render_data=torch.tensor([[4.0, 0.0, 0.0, 0.0]]))
    img = render.render_particles(one, tiled.TiledRasterConfig(
        height=H, width=W), z_to_y=1.0)[0].numpy()
    # Screen y = 40 - 10 = 30.
    assert img[28:33, 30:35].sum() > img[38:43, 30:35].sum()


@pytest.mark.parametrize("kw", [
    dict(appearance=render.ParticleAppearance(texture=np.ones((4, 4)))),
    dict(appearance=render.ParticleAppearance(rounded=True,
                                              rounding_power_from_life=0.5)),
    dict(additive_blend=False),
])
def test_unported_routes_raise(kw):
    _, ts = _state(16)
    with pytest.raises(NotImplementedError, match="ROADMAP M11"):
        render.render_particles(ts, tiled.TiledRasterConfig(height=H,
                                                            width=W), **kw)


SCATTER = {
    "splat": ("splat_additive", dict(z_to_y=0.5, render_scale=1.25,
                                     global_color=np.asarray(
                                         [1.0, 0.5, 0.25, 1.0], np.float32))),
    "rounded": ("rasterize_additive", dict(footprint=7, z_to_y=1.0)),
    "box": ("rasterize_additive", dict(footprint=5, rounded=False,
                                       size_scale=1.5)),
    "stippled": ("rasterize_additive", dict(stipple_factor=0.3,
                                            render_scale=0.75,
                                            global_color=np.float32(2.0))),
}


@pytest.mark.parametrize("case", sorted(SCATTER))
def test_scatter_oracle_matches_jax(case):
    """The same float32 coverage scattered with index_add_ as with XLA's
    scatter-add: equal to float32 summation order."""
    fn, kw = SCATTER[case]
    js, ts = _state(seed=2)
    ref = np.asarray(getattr(jparticles, fn)(js, H, W, **kw))
    out = getattr(particles, fn)(ts, H, W, **kw).numpy()
    assert float(np.abs(ref).sum()) > 1.0
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    with pytest.raises(NotImplementedError, match="ROADMAP M11"):
        particles.rasterize_additive(ts, H, W, rounding_power=0.5)
