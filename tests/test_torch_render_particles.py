"""ParticleSystem.Render of the port against the JAX package: every route
of `render_particles` (untextured additive and ordered alpha, dithered,
depth-ordered, over a background; textured sprites additive and alpha,
RelativeSize, a velocity-driven sprite sheet; the RoundingPowerFromLife
disc tables), and the exact scatter oracle (`splat_additive`,
`rasterize_additive`, with and without a rounding power)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from illuminant_tpu.ops import bezier as jbezier
from illuminant_tpu.particles.state import ParticleState as JState
from illuminant_tpu.raster import particles as jparticles
from illuminant_tpu.raster import render as jrender
from illuminant_tpu.raster import tiled as jtiled
from illuminant_tpu_torch.core import interop
from illuminant_tpu_torch.ops import bezier
from illuminant_tpu_torch.particles.state import ParticleState
from illuminant_tpu_torch.raster import particles, render, tiled

torch.set_num_threads(1)
H, W = 64, 96


def _state(n=500, seed=0, alpha=False):
    """Live and dead particles on the JAX payload's 1/16-px grid (z too,
    so that z_to_y = 1 keeps screen y on it), some off screen, with
    velocities and life for the sprite-sheet frame. `alpha`: premultiplied
    colours of opacity 0.3-1, rounded to bf16 as the JAX bins carry
    them."""
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
    vel = np.zeros((n, 4), np.float32)
    vel[:, :3] = rng.normal(0.0, 20.0, (n, 3))
    rd[:, 1] = rng.uniform(-7.0, 7.0, n)
    pos[:, 3] += np.where(pos[:, 3] > 0, rng.uniform(0.0, 3.0, n), 0.0)
    if alpha:
        a = rng.uniform(0.3, 1.0, n)
        rc = torch.as_tensor(np.concatenate(
            [rc[:, :3] / 1.5 * a[:, None], a[:, None]], axis=1),
            dtype=torch.float32).to(torch.bfloat16).float().numpy()
    d = dict(position=pos, velocity=vel, color=z, render_color=rc,
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
    # The ordered alpha routes and the sprite tables (ROADMAP M11).
    "alpha": dict(additive_blend=False),
    "alpha_round": dict(appearance="rounded", additive_blend=False),
    "alpha_glow_opaque_background": dict(appearance="glow",
                                         additive_blend=False,
                                         background="image"),
    "alpha_dithered": dict(appearance="dithered", additive_blend=False),
    "alpha_z_formula": dict(additive_blend=False,
                            z_formula=(0.0, 0.5, 1.0, 0.0)),
    "textured": dict(appearance="textured"),
    "textured_alpha_z_formula": dict(appearance="textured",
                                     additive_blend=False,
                                     z_formula=(0.0, 0.0, 1.0, 0.0)),
    "textured_relative_size": dict(appearance="relative"),
    "textured_velocity_sheet": dict(appearance="sheet",
                                    additive_blend=False),
    "power_disc": dict(appearance="power"),
    "power_disc_curve_alpha": dict(appearance="power_curve",
                                   additive_blend=False),
}
# Colours with opacity at most 1 for the alpha routes.
ALPHA = {c for c, kw in CASES.items() if kw.get("additive_blend") is False}


def _leaf(n=12):
    ys, xs = np.meshgrid(np.linspace(-1, 1, n), np.linspace(-1, 1, n),
                         indexing="ij")
    return (np.clip(1.0 - (np.abs(xs) ** 1.5 + np.abs(ys * 1.6) ** 1.5),
                    0, 1) ** 0.8).astype(np.float32)


# One texture object for both packages: the tables are keyed on its id.
LEAF = _leaf()
SHEET = np.concatenate([np.concatenate([LEAF, LEAF[::-1]], 1),
                        np.concatenate([LEAF.T, LEAF * 0.5], 1)], 0)
# Sprite supports of at most 9 px fit the default apron of 4.
SPRITE = dict(size_min=2.0, size_max=8.0, angle_bins=4, size_bins=3, rank=3)
APPEARANCES = {
    "rounded": dict(rounded=True),
    "glow": dict(glow=True),
    "kernel": dict(kernel="round"),
    "dithered": dict(dithered_opacity=True),
    "textured": dict(texture=LEAF, **SPRITE),
    "relative": dict(texture=LEAF, relative_size=True, **SPRITE),
    "sheet": dict(texture=SHEET, columns=2, rows=2,
                  column_from_velocity=True, animation_rate=(0.0, 1.5),
                  **SPRITE),
    "power": dict(rounded=True, rounding_power_from_life=0.5,
                  size_min=2.0, size_max=8.0, rank=3),
}


def _kwargs(mod, case):
    kw = dict(CASES[case])
    app = kw.pop("appearance", None)
    if app == "power_curve":
        # Rounding power 0.1 -> 0.9 over the particles' life of 0-4.
        pack = (jbezier if mod is jrender else bezier).pack_bezier
        kw["appearance"] = mod.ParticleAppearance(
            rounded=True, size_min=2.0, size_max=8.0, rank=3, power_bins=4,
            rounding_power_from_life=pack([[0.1], [0.9]], 0.0, 4.0))
    elif app:
        kw["appearance"] = mod.ParticleAppearance(**APPEARANCES[app])
    if kw.get("background") == "image":
        kw["background"] = np.random.default_rng(1).uniform(
            0, 0.3, (H, W, 4)).astype(np.float32)
    return kw


@pytest.mark.parametrize("case", sorted(CASES))
def test_render_particles_matches_jax(case):
    js, ts = _state(alpha=case in ALPHA)
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
    assert float(np.abs(b).sum()) > 1.0
    if case == "alpha_dithered":
        # The Bayer discard flips a pixel whose alpha lies within the bf16
        # rounding of a threshold: at most 0.5% of them.
        assert (np.abs(a - b) > 1e-5).any(-1).mean() <= 0.005, case
        return
    # tests/test_torch_raster.py::test_round_matches_jax_parity_preset's
    # bounds: the JAX side carries colours and coverage in bf16 through
    # its bins (and sprite factors, sprites.py:317-338); the port is
    # float32.
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


def test_tables_are_cached_per_device():
    """An appearance builds its sprite table once and moves it to a device
    once; a new texture rebuilds it (the JAX package's key)."""
    app = render.ParticleAppearance(texture=LEAF, **SPRITE)
    first = app.sprite_table("cpu")
    assert app.sprite_table("cpu") is first
    app.texture = LEAF.copy()
    assert app.sprite_table("cpu") is not first
    ptable, powers = render.ParticleAppearance(
        rounded=True, rounding_power_from_life=0.5).power_disc_table("cpu")
    assert powers == (0.5,) and ptable.frames == 1


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
    "rounding_power": ("rasterize_additive", dict(footprint=7,
                                                  rounding_power=0.35)),
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
