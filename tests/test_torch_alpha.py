"""The ordered alpha route of the port (`tiled.bin_footprints`,
`composite_over_tiles`, `rasterize_tiled_alpha`) against the JAX package's
on the CPU, at 64 x 96.

The JAX side rounds on purpose, and the tests reproduce that on the
inputs, never in the port: positions on the 1/16-px grid of its payload
(tiled.py:119), colours and sizes representable in bf16 (its bins carry
them as bf16 pairs with `rgba8_colors=False`). Its coverage factors and
their product are bf16 (tiled.py:544): exact for the quad at these inputs
(multiples of 1/16, their products of 1/256), so the quad cases agree to
float32 rounding (1e-5), dithered ones included; the Gaussian and the
round profile are held at bf16: 2^-8 plus 1e-3 on values of at most 1,
and a dithered image may flip a pixel whose alpha lies within that of a
Bayer threshold: at most 0.5% of them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from illuminant_tpu.raster import tiled as jtiled
from illuminant_tpu_torch.raster import tiled

torch.set_num_threads(1)
H, W = 64, 96
BF16_BOUND = 2.0 ** -8 + 1e-3
FLIP_SHARE = 0.005


def _bf16(a):
    return torch.as_tensor(np.asarray(a, np.float32)).to(
        torch.bfloat16).to(torch.float32).numpy()


def _cloud(n=300, seed=0, size=(1.0, 10.0), grid=16):
    """n particles over the frame and past its edges on the 1/grid-px
    grid, premultiplied bf16 colours, bf16 sizes, 90% live."""
    rng = np.random.default_rng(seed)
    x = np.round(rng.uniform(-3, W + 3, n) * grid) / grid
    y = np.round(rng.uniform(-3, H + 3, n) * grid) / grid
    a = rng.uniform(0.3, 1.0, n)
    st = rng.uniform(0.1, 1.0, (n, 3))
    color = _bf16(np.concatenate([st * a[:, None], a[:, None]], axis=1))
    sizes = _bf16(rng.uniform(size[0], size[1], n))
    live = rng.uniform(size=n) < 0.9
    return (x.astype(np.float32), y.astype(np.float32), color, sizes, live)


def _both(kernel="quad", apron=4, **kw):
    return (jtiled.TiledRasterConfig(height=H, width=W, bin_capacity=512,
                                     rgba8_colors=False, kernel=kernel,
                                     apron=apron, **kw),
            tiled.TiledRasterConfig(height=H, width=W, kernel=kernel,
                                    apron=apron, **kw))


def _run(kernel, inputs, background=None, dither=False, opacity=None,
         apron=4):
    cj, ct = _both(kernel, apron)
    ref, jd = jtiled.rasterize_tiled_alpha(
        cj, *map(jnp.asarray, inputs),
        background=None if background is None else jnp.asarray(background),
        dither=dither, opacity=opacity)
    out, diag = tiled.rasterize_tiled_alpha(
        ct, *map(torch.as_tensor, inputs),
        background=None if background is None else torch.as_tensor(
            background), dither=dither, opacity=opacity)
    assert int(jd["dropped"]) == 0 and diag["dropped"] == 0
    return out.numpy().astype(np.float64), np.asarray(ref, np.float64)


@pytest.mark.parametrize("replicate", [True, False])
def test_bins_match_jax(replicate):
    """Every tile lists the same particles in the same (draw) order as the
    JAX bins: replicated into each tile the support box touches, or each
    in its own tile."""
    x, y, color, size, live = _cloud(seed=1, size=(1.0, 14.0))
    cj, ct = _both(apron=6)
    jb = jtiled.bin_particles(cj, *map(jnp.asarray, (x, y, color, size,
                                                      live)),
                              replicate_footprint=replicate)
    ids, starts = tiled.bin_footprints(
        ct, torch.as_tensor(x), torch.as_tensor(y), torch.as_tensor(live),
        torch.as_tensor(size) if replicate else None)
    counts = np.diff(starts.numpy())
    np.testing.assert_array_equal(counts, np.asarray(jb["counts"]))
    assert counts.sum() > (live.sum() if replicate else 0)
    jx, jy = np.asarray(jb["x"]), np.asarray(jb["y"])
    for t, (s, c) in enumerate(zip(starts.numpy()[:-1], counts)):
        mine = ids.numpy()[s:s + c]
        assert (np.diff(mine) > 0).all()
        np.testing.assert_array_equal(x[mine], jx[t, :c])
        np.testing.assert_array_equal(y[mine], jy[t, :c])


@pytest.mark.parametrize("kernel", ["quad", "gauss", "round"])
@pytest.mark.parametrize("mode", ["plain", "dither", "background_opacity"])
def test_alpha_matches_jax(kernel, mode):
    """A cloud crossing every tile border and the frame's edges."""
    inputs = _cloud(seed=2)
    bg = np.random.default_rng(3).uniform(0, 1, (H, W, 4)).astype(np.float32)
    out, ref = _run(kernel, inputs, dither=mode == "dither",
                    background=bg if mode == "background_opacity" else None,
                    opacity=0.7 if mode == "background_opacity" else None)
    assert np.abs(ref).sum() > 1.0
    if kernel == "quad":
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    elif mode == "dither":
        assert (np.abs(out - ref) > 1e-5).any(-1).mean() <= FLIP_SHARE
    else:
        np.testing.assert_allclose(out, ref, rtol=0, atol=BF16_BOUND)
    assert out[..., 3].max() <= 1.0 + 1e-5


def test_alpha_ordering_last_on_top():
    """tests/test_tiled_raster.py:172-185: the later of two opaque quads
    wins."""
    inputs = (np.asarray([16.0, 16.0], np.float32),
              np.asarray([16.0, 16.0], np.float32),
              np.asarray([[1, 0, 0, 1], [0, 1, 0, 1]], np.float32),
              np.asarray([8.0, 8.0], np.float32), np.ones(2, bool))
    out, ref = _run("quad", inputs)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    assert out[16, 16, 1] > 0.9 and out[16, 16, 0] < 0.1


def test_alpha_over_background():
    """tests/test_tiled_raster.py:188-205: 50% red over blue, the corner
    untouched."""
    inputs = (np.asarray([16.0], np.float32), np.asarray([16.0], np.float32),
              np.asarray([[0.5, 0.0, 0.0, 0.5]], np.float32),
              np.asarray([6.0], np.float32), np.ones(1, bool))
    bg = np.broadcast_to(np.asarray([0.0, 0.0, 1.0, 1.0], np.float32),
                         (H, W, 4)).copy()
    out, ref = _run("quad", inputs, background=bg)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(out[16, 16, :3], [0.5, 0.0, 0.5], atol=0.05)
    np.testing.assert_allclose(out[2, 2, :3], [0.0, 0.0, 1.0], atol=1e-5)


def test_dithered_opacity_is_binary():
    """tests/test_tiled_raster.py:208-225 with the quad centred on the
    grid: the same binary alpha, Bayer phase included."""
    inputs = (np.asarray([16.0], np.float32), np.asarray([16.0], np.float32),
              np.asarray([[0.5, 0.5, 0.5, 0.5]], np.float32),
              np.asarray([12.0], np.float32), np.ones(1, bool))
    out, ref = _run("quad", inputs, dither=True)
    np.testing.assert_array_equal(out, ref)
    inside = out[13:20, 13:20, 3]
    assert set(np.round(np.unique(inside), 5)) <= {0.0, 1.0}
    assert 0.3 < inside.mean() < 0.7


def test_dither_phase_is_screen_space():
    """Opaque-enough quads centred in tiles away from the origin: the
    Bayer pattern follows the screen (the JAX package's (p - apron) % 4
    phase), in every tile."""
    xs = np.asarray([16.0, 48.0, 80.0, 16.0, 48.0, 80.0], np.float32)
    ys = np.asarray([16.0, 16.0, 16.0, 48.0, 48.0, 48.0], np.float32)
    color = _bf16(np.tile([[0.3, 0.2, 0.1, 0.45]], (6, 1)))
    inputs = (xs, ys, color, np.full(6, 16.0, np.float32), np.ones(6, bool))
    out, ref = _run("quad", inputs, dither=True)
    np.testing.assert_array_equal(out, ref)
    # Full coverage within 4 px of each centre: alpha 0.45 beats the
    # thresholds 0/16 .. 7/16, half of the 4 x 4 pattern, at the same
    # screen phase in every tile.
    cores = [out[int(cy) - 4:int(cy) + 4, int(cx) - 4:int(cx) + 4, 3]
             for cx, cy in zip(xs, ys)]
    for core in cores:
        np.testing.assert_array_equal(core, cores[0])
    assert cores[0].mean() == 0.5


def test_alpha_cross_tile_overlap_matches_jax():
    """tests/test_tiled_raster.py:429-460: opaque pairs straddling every
    tile border and a cloud 'over'-composite; accumulated alpha <= 1."""
    xs_ = [29.0, 33.0, 61.0, 66.0, 31.5, 32.5]
    ys_ = [16.0, 16.0, 40.0, 40.0, 33.0, 31.0]
    rng = np.random.default_rng(21)
    xs_ += list(np.round(rng.uniform(0, W, 40) * 16) / 16)
    ys_ += list(np.round(rng.uniform(0, H, 40) * 16) / 16)
    n = len(xs_)
    color = np.zeros((n, 4), np.float32)
    color[:, 3] = rng.uniform(0.5, 1.0, n)
    color[:, :3] = rng.uniform(0.2, 1.0, (n, 3)) * color[:, 3:4]
    inputs = (np.asarray(xs_, np.float32), np.asarray(ys_, np.float32),
              _bf16(color), np.full(n, 6.0, np.float32), np.ones(n, bool))
    out, ref = _run("quad", inputs)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    assert out[..., 3].max() <= 1.0 + 1e-5


def test_alpha_background_and_opacity():
    """tests/test_tiled_raster.py:463-483: premultiplied-over background
    alpha (a + bg_a (1 - a), not max) and the global opacity."""
    inputs = (np.asarray([16.0], np.float32), np.asarray([16.0], np.float32),
              _bf16([[0.8, 0.4, 0.2, 0.8]]),
              np.asarray([8.0], np.float32), np.ones(1, bool))
    bg = np.full((H, W, 4), 0.5, np.float32)
    out, ref = _run("quad", inputs, background=bg, opacity=0.5)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    # Centre: a = 0.4 of straight (1, 0.5, 0.25) over 0.5 grey (to the
    # bf16 rounding of the colours).
    np.testing.assert_allclose(out[16, 16], [0.7, 0.5, 0.4, 0.7],
                               atol=1e-3)


def test_gaussian_tail_is_cut_at_the_tile_border():
    """The binning rule, not the profile's reach, decides which tiles a
    particle composites into (the JAX package's r_sup box): a glow just
    left of a tile border shades the next tile only where that box
    reaches it, so both packages leave the pixels past it untouched."""
    inputs = (np.asarray([28.0], np.float32), np.asarray([16.0], np.float32),
              np.asarray([[0.5, 0.5, 0.5, 0.5]], np.float32),
              np.asarray([5.0], np.float32), np.ones(1, bool))
    out, ref = _run("gauss", inputs)
    np.testing.assert_allclose(out, ref, rtol=0, atol=BF16_BOUND)
    # r_sup = 2.5 + 0.5: the box ends at x = 31, inside tile 0; the
    # profile (support 2r = 5 px) would reach x = 33.
    assert out[16, 31, 3] > 0.0 and out[16, 32:34, 3].max() == 0.0
    assert ref[16, 32:34, 3].max() == 0.0


def test_alpha_needs_four_channels():
    ct = tiled.TiledRasterConfig(height=H, width=W, channels=3)
    x, y, color, size, live = map(torch.as_tensor, _cloud(n=4))
    with pytest.raises(ValueError, match="4"):
        tiled.rasterize_tiled_alpha(ct, x, y, color, size, live)
