"""The port's sprite tables and textured-sprite routes against the JAX
package's on the CPU, at 64 x 96 (and the sizes of tests/test_sprites.py).

The tables come from the same numpy SVD and must be equal bit for bit;
variant and frame selection must be equal. The rasterized images are held
to the JAX function at bf16: its bins carry positions on the 1/16-px grid
and colours as bf16 (reproduced on the inputs here), and it accumulates
each rank's lerped factors in bf16 (sprites.py:317-338) and multiplies
colours by them in bf16 (:366-368), four roundings of at most 2^-9 each:
  * additive: |port - JAX| <= 4 x 2^-8 x the image of the absolute
    factors and colours (a bound on the sum of the terms' magnitudes,
    since the SVD factors have both signs) + 1e-3;
  * alpha, on values of at most 1: 4 x 2^-8 + 1e-3; dithered, at most
    0.5% of pixels flipped.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from illuminant_tpu.particles.state import ParticleState as JState
from illuminant_tpu.raster import render as jrender
from illuminant_tpu.raster import sprites as jsprites
from illuminant_tpu.raster import tiled as jtiled
from illuminant_tpu_torch.particles.state import ParticleState
from illuminant_tpu_torch.raster import render, sprites, tiled

torch.set_num_threads(1)
H, W = 64, 96
BOUND = 4 * 2.0 ** -8
FLIP_SHARE = 0.005


def _bf16(a):
    return torch.as_tensor(np.asarray(a, np.float32)).to(
        torch.bfloat16).to(torch.float32).numpy()


def _glow_texture(n=16):
    ys, xs = np.meshgrid(np.linspace(-1, 1, n), np.linspace(-1, 1, n),
                         indexing="ij")
    r = np.sqrt(ys ** 2 + xs ** 2)
    return np.clip(1.0 - r, 0.0, 1.0).astype(np.float32) ** 1.5


def _leaf(n=24):
    ys, xs = np.meshgrid(np.linspace(-1, 1, n), np.linspace(-1, 1, n),
                         indexing="ij")
    return (np.clip(1.0 - (np.abs(xs) ** 1.5 + np.abs(ys * 1.6) ** 1.5),
                    0, 1) ** 0.8).astype(np.float32)


def _bar():
    tex = np.zeros((16, 16), np.float32)
    tex[6:10, 2:14] = 1.0
    return tex


def _sheet():
    tex = np.zeros((8, 16), np.float32)
    tex[:, :8] = 1.0
    tex[:, 8:] = 0.25
    return tex


TABLES = {
    "glow": (_glow_texture, dict(rank=3, size_bins=2, size_min=4.0,
                                 size_max=8.0, support=11)),
    "bar_rotated": (_bar, dict(angle_bins=4, rank=4, size_bins=1,
                               size_min=10.0, size_max=10.0, support=13)),
    "sheet": (_sheet, dict(frames_x=2, rank=2, size_bins=1, size_min=6.0,
                           size_max=6.0, support=9)),
    "leaf_cell": (_leaf, dict(angle_bins=8, rank=4, size_bins=4,
                              size_min=8.0, size_max=18.0)),
    "rgba_grid": (lambda: np.random.default_rng(0).uniform(
        0, 1, (16, 32, 4)).astype(np.float32),
        dict(frames_x=2, frames_y=2, angle_bins=3, rank=5, size_bins=2)),
}


def _tables(name):
    make, kw = TABLES[name]
    tex = make()
    return (jsprites.build_sprite_table(tex, **kw),
            sprites.build_sprite_table(tex, device="cpu", **kw))


def _assert_tables_equal(tj, tp):
    np.testing.assert_array_equal(tp.row_factors.numpy(),
                                  np.asarray(tj.row_factors))
    np.testing.assert_array_equal(tp.col_factors.numpy(),
                                  np.asarray(tj.col_factors))
    for f in ("frames", "angle_bins", "size_bins", "size_min", "size_max",
              "residual", "rank", "support"):
        assert getattr(tp, f) == getattr(tj, f), f


@pytest.mark.parametrize("name", sorted(TABLES))
def test_tables_equal_jax(name):
    _assert_tables_equal(*_tables(name))


def test_power_disc_table_equals_jax():
    kw = dict(size_min=3.0, size_max=8.0, size_bins=3, rank=3)
    powers = (0.05, 0.4, 0.8, 1.0)
    _assert_tables_equal(jsprites.build_power_disc_table(powers, **kw),
                         sprites.build_power_disc_table(powers, device="cpu",
                                                        **kw))


def test_render_variant_and_circular_alpha_equal_jax():
    tex = _leaf()
    for angle, size in ((0.0, 8.0), (1.1, 13.5), (np.pi, 18.0)):
        np.testing.assert_array_equal(
            sprites._render_variant(tex, angle, size, 19),
            jsprites._render_variant(tex, angle, size, 19))
    d = np.linspace(0.0, 1.5, 301)
    for p in (0.0005, 0.05, 0.5, 1.0, 2.0):
        np.testing.assert_array_equal(sprites.circular_alpha(d, p),
                                      jsprites.circular_alpha(d, p))
        np.testing.assert_allclose(
            sprites.circular_alpha(torch.as_tensor(d, dtype=torch.float32),
                                   p).numpy(),
            np.asarray(jsprites.circular_alpha(jnp.asarray(d, jnp.float32),
                                               p)), rtol=0, atol=1e-6)


def test_too_many_variants_raise_in_both():
    tex = _glow_texture()
    kw = dict(frames_x=2, frames_y=2, angle_bins=8, size_bins=9)
    with pytest.raises(ValueError, match="256"):
        jsprites.build_sprite_table(tex, **kw)
    with pytest.raises(ValueError, match="256"):
        sprites.build_sprite_table(tex, device="cpu", **kw)


def test_select_bins_equal_jax():
    tj, tp = _tables("rgba_grid")
    rng = np.random.default_rng(4)
    n = 2000
    frame = rng.uniform(-1, 6, n).astype(np.float32)
    angle = rng.uniform(-20, 20, n).astype(np.float32)
    angle[:5] = [0.0, -np.pi / 3, np.pi / 3, 2 * np.pi, -2 * np.pi]
    size = rng.uniform(0.5, 20, n).astype(np.float32)
    want = np.asarray(jsprites.select_bins(
        tj, jnp.asarray(frame), jnp.asarray(angle), jnp.asarray(size)))
    got = sprites.select_bins(tp, torch.as_tensor(frame),
                              torch.as_tensor(angle), torch.as_tensor(size))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kw", [
    dict(column_from_velocity=True, frames_x=2),
    dict(row_from_velocity=True, frames_x=2),
    dict(animation_rate=(3.0, 0.0), frames_x=2),
    dict(animation_rate=(1.5, 2.5), frames_x=2),
    dict(animation_rate=(2.0, 0.0), row_from_velocity=True, frames_x=2),
])
def test_animation_frame_equal_jax(kw):
    tj, tp = _tables("rgba_grid")
    rng = np.random.default_rng(5)
    n = 500
    life = rng.uniform(0, 5, n).astype(np.float32)
    vel = rng.normal(0, 10, (n, 3)).astype(np.float32)
    vel[:4, :2] = [[1, 0], [0, 1], [-1, 0], [0, -1]]
    want = np.asarray(jsprites.animation_frame(tj, jnp.asarray(life),
                                               jnp.asarray(vel), **kw))
    got = sprites.animation_frame(tp, torch.as_tensor(life),
                                  torch.as_tensor(vel), **kw)
    np.testing.assert_array_equal(got.numpy(), want)


def test_animation_frame_from_velocity():
    """tests/test_sprites.py:129-139: four headings pick four columns."""
    tex = np.ones((8, 32), np.float32)
    tp = sprites.build_sprite_table(tex, frames_x=4, rank=1, size_bins=1,
                                    support=9, device="cpu")
    vel = torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                        [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
    frames = sprites.animation_frame(tp, torch.zeros(4), vel,
                                     column_from_velocity=True, frames_x=4)
    assert sorted(frames.tolist()) == [0, 1, 2, 3]


def _cfgs(apron, h=H, w=W, channels=4, capacity=512):
    return (jtiled.TiledRasterConfig(height=h, width=w, tile=32,
                                     bin_capacity=capacity, apron=apron,
                                     rgba8_colors=False, channels=channels),
            tiled.TiledRasterConfig(height=h, width=w, tile=32, apron=apron,
                                    channels=channels))


def _additive_bound(cfg, tp, x, y, color, size, live, **kw):
    """The port's image with every factor and colour made positive: at
    each pixel at least the sum of the magnitudes of its terms."""
    tabs = tp.replace(row_factors=tp.row_factors.abs(),
                      col_factors=tp.col_factors.abs())
    return sprites.rasterize_sprites(cfg, tabs, x, y, color.abs(), size,
                                     live, **kw)[0].numpy()


def _sprite_case(name, n, seed, size, h=H, w=W, rotate=True, frames=0):
    rng = np.random.default_rng(seed)
    x = np.round(rng.uniform(-3, w + 3, n) * 16) / 16
    y = np.round(rng.uniform(-3, h + 3, n) * 16) / 16
    a = rng.uniform(0.3, 1.0, n)
    st = rng.uniform(0.1, 1.0, (n, 3))
    color = _bf16(np.concatenate([st * a[:, None], a[:, None]], axis=1))
    sz = rng.uniform(size[0], size[1], n).astype(np.float32)
    live = rng.uniform(size=n) < 0.9
    rot = rng.uniform(-7, 7, n).astype(np.float32) if rotate else None
    frame = (rng.integers(0, frames, n).astype(np.float32) if frames
             else None)
    return (x.astype(np.float32), y.astype(np.float32), color, sz, live,
            rot, frame)


def _compare_sprites(name, case, apron, alpha, dither=False,
                     background=None):
    tj, tp = _tables(name)
    x, y, color, size, live, rot, frame = case
    cj, ct = _cfgs(apron)
    kw_j = dict(rotation=None if rot is None else jnp.asarray(rot),
                frame=None if frame is None else jnp.asarray(frame))
    kw_t = dict(rotation=None if rot is None else torch.as_tensor(rot),
                frame=None if frame is None else torch.as_tensor(frame))
    args_j = map(jnp.asarray, (x, y, color, size, live))
    args_t = list(map(torch.as_tensor, (x, y, color, size, live)))
    if alpha:
        bg_j = None if background is None else jnp.asarray(background)
        bg_t = None if background is None else torch.as_tensor(background)
        ref, jd = jsprites.rasterize_sprites_alpha(
            cj, tj, *args_j, background=bg_j, dither=dither, **kw_j)
        out, diag = sprites.rasterize_sprites_alpha(
            ct, tp, *args_t, background=bg_t, dither=dither, **kw_t)
    else:
        ref, jd = jsprites.rasterize_sprites(cj, tj, *args_j, **kw_j)
        out, diag = sprites.rasterize_sprites(ct, tp, *args_t, **kw_t)
    assert int(jd["dropped"]) == 0 and diag["dropped"] == 0
    assert diag["residual"] == jd["residual"]
    out, ref = out.numpy().astype(np.float64), np.asarray(ref, np.float64)
    assert np.abs(ref).sum() > 1.0
    if not alpha:
        bound = _additive_bound(ct, tp, *args_t, **kw_t)
        assert (np.abs(out - ref) <= BOUND * bound + 1e-3).all(), \
            np.abs(out - ref).max()
    elif dither:
        assert (np.abs(out - ref) > 1e-5).any(-1).mean() <= FLIP_SHARE
    else:
        np.testing.assert_allclose(out, ref, rtol=0, atol=BOUND + 1e-3)
        assert out[..., 3].max() <= 1.0 + 1e-5
    return out


@pytest.mark.parametrize("alpha", [False, True])
@pytest.mark.parametrize("name", ["glow", "leaf_cell", "rgba_grid"])
def test_sprite_routes_match_jax(name, alpha):
    """Rotated (and, on the sheet, framed) sprites over the frame's edges
    and every tile border, additive and ordered alpha."""
    support = _tables(name)[1].support
    case = _sprite_case(name, 250, 6, (3.0, 18.0), frames=4
                        if name == "rgba_grid" else 0)
    _compare_sprites(name, case, support // 2, alpha)


@pytest.mark.parametrize("mode", ["dither", "background"])
def test_sprite_alpha_dither_and_background_match_jax(mode):
    case = _sprite_case("leaf_cell", 250, 7, (8.0, 18.0))
    bg = np.random.default_rng(8).uniform(0, 1, (H, W, 4)).astype(
        np.float32)
    _compare_sprites("leaf_cell", case, 9, True, dither=mode == "dither",
                     background=bg if mode == "background" else None)


def test_sprites_match_oracle():
    """tests/test_sprites.py:28-71: pixel-centred glows of the three size
    bins on a 96 x 96 frame, held to the JAX function."""
    tex = _glow_texture()
    support = 11
    kw = dict(rank=4, size_bins=3, size_min=3.0, size_max=9.0,
              support=support)
    tj = jsprites.build_sprite_table(tex, **kw)
    tp = sprites.build_sprite_table(tex, device="cpu", **kw)
    cj, ct = _cfgs(support // 2, 96, 96, capacity=64)
    rng = np.random.default_rng(5)
    n = 60
    x = (np.round(rng.uniform(8, 88, n)) + 0.5).astype(np.float32)
    y = (np.round(rng.uniform(8, 88, n)) + 0.5).astype(np.float32)
    color = _bf16(rng.uniform(0.2, 1.0, (n, 4)))
    size = rng.choice([3.0, 5.196, 9.0], n).astype(np.float32)
    live = np.ones(n, bool)
    ref = np.asarray(jsprites.rasterize_sprites(
        cj, tj, *map(jnp.asarray, (x, y, color, size, live)))[0])
    args = list(map(torch.as_tensor, (x, y, color, size, live)))
    out = sprites.rasterize_sprites(ct, tp, *args)[0].numpy()
    bound = _additive_bound(ct, tp, *args)
    assert (np.abs(out - ref) <= BOUND * bound + 1e-3).all()
    assert abs(out.sum() - ref.sum()) / ref.sum() < 1e-3


def test_rotation_bins_rotate_sprite():
    """tests/test_sprites.py:74-96: the bar at 0 and pi/2 is wide, then
    tall; equal to the JAX image at the bound."""
    tj, tp = _tables("bar_rotated")
    cj, ct = _cfgs(6, 64, 64, capacity=16)
    x, y = np.asarray([20.0, 44.0]), np.asarray([32.0, 32.0])
    args = (x, y, np.ones((2, 4)), np.full(2, 10.0), np.ones(2, bool))
    rot = np.asarray([0.0, np.pi / 2.0], np.float32)
    ref = np.asarray(jsprites.rasterize_sprites(
        cj, tj, *(jnp.asarray(a, jnp.float32 if a.dtype != bool else None)
                  for a in args), rotation=jnp.asarray(rot))[0])
    targs = [torch.as_tensor(a, dtype=torch.float32 if a.dtype != bool
                             else None) for a in args]
    img = sprites.rasterize_sprites(ct, tp, *targs,
                                    rotation=torch.as_tensor(rot))[0]
    img = img.numpy()
    bound = _additive_bound(ct, tp, *targs, rotation=torch.as_tensor(rot))
    assert (np.abs(img - ref) <= BOUND * bound + 1e-3).all()
    assert img[32, 16:25, 0].sum() > img[28:37, 20, 0].sum() * 1.5
    assert img[28:37, 44, 0].sum() > img[32, 40:49, 0].sum() * 1.5


def test_sprite_sheet_frame_selection():
    """tests/test_sprites.py:99-116: frame 0 (bright) against frame 1."""
    tj, tp = _tables("sheet")
    cj, ct = _cfgs(4, 64, 64, capacity=16)
    x = np.asarray([20.0, 44.0], np.float32)
    y = np.asarray([32.0, 32.0], np.float32)
    frame = np.asarray([0.0, 1.0], np.float32)
    args = (x, y, np.ones((2, 4), np.float32), np.full(2, 6.0, np.float32),
            np.ones(2, bool))
    ref = np.asarray(jsprites.rasterize_sprites(
        cj, tj, *map(jnp.asarray, args), frame=jnp.asarray(frame))[0])
    img = sprites.rasterize_sprites(ct, tp, *map(torch.as_tensor, args),
                                    frame=torch.as_tensor(frame))[0].numpy()
    np.testing.assert_allclose(img, ref, rtol=0, atol=BOUND + 1e-3)
    assert img[32, 20, 0] > img[32, 44, 0] * 2.5


def test_sprites_alpha_matches_oracle():
    """tests/test_sprites.py:142-192: pixel-centred glows over one
    another in index order, held to the JAX function."""
    tex = _glow_texture()
    support = 11
    kw = dict(rank=4, size_bins=1, size_min=7.0, size_max=7.0,
              support=support)
    tj = jsprites.build_sprite_table(tex, **kw)
    tp = sprites.build_sprite_table(tex, device="cpu", **kw)
    cj, ct = _cfgs(support // 2, 64, 64, capacity=64)
    rng = np.random.default_rng(7)
    n = 40
    x = (np.round(rng.uniform(8, 56, n)) + 0.5).astype(np.float32)
    y = (np.round(rng.uniform(8, 56, n)) + 0.5).astype(np.float32)
    straight = rng.uniform(0.2, 1.0, (n, 3))
    alpha = rng.uniform(0.3, 0.9, n)
    color = _bf16(np.concatenate([straight * alpha[:, None],
                                  alpha[:, None]], axis=1))
    args = (x, y, color, np.full(n, 7.0, np.float32), np.ones(n, bool))
    ref = np.asarray(jsprites.rasterize_sprites_alpha(
        cj, tj, *map(jnp.asarray, args))[0])
    img = sprites.rasterize_sprites_alpha(
        ct, tp, *map(torch.as_tensor, args))[0].numpy()
    np.testing.assert_allclose(img, ref, rtol=0, atol=BOUND + 1e-3)


def test_sprites_alpha_draw_order_last_on_top():
    """tests/test_sprites.py:195-213: of two opaque squares, the later
    (blue) wins."""
    kw = dict(rank=2, size_bins=1, size_min=6.0, size_max=6.0, support=9)
    tex = np.ones((8, 8), np.float32)
    tp = sprites.build_sprite_table(tex, device="cpu", **kw)
    _, ct = _cfgs(4, 32, 32)
    img = sprites.rasterize_sprites_alpha(
        ct, tp, torch.tensor([16.0, 16.0]), torch.tensor([16.0, 16.0]),
        torch.tensor([[1.0, 0, 0, 1], [0, 0, 1.0, 1]]),
        torch.tensor([6.0, 6.0]), torch.tensor([True, True]))[0]
    c = img[16, 16]
    assert c[2] > 0.9 and c[0] < 0.1, c


def _two_leaves(module, state_cls, to_array):
    """tests/test_sprites.py:216-254's state: red near (z 10) at index 0,
    blue far (z 50) at index 1, over each other."""
    pos = np.zeros((4, 4), np.float32)
    pos[0] = [16, 16, 10, 1.0]
    pos[1] = [16, 16, 50, 1.0]
    rc = np.zeros((4, 4), np.float32)
    rc[0] = [1, 0, 0, 1]
    rc[1] = [0, 0, 1, 1]
    rd = np.zeros((4, 4), np.float32)
    rd[:2, 0] = 6.0
    z = np.zeros((4, 4), np.float32)
    return state_cls(position=to_array(pos), velocity=to_array(z),
                     color=to_array(z), render_color=to_array(rc),
                     render_data=to_array(rd),
                     write_cursor=to_array(np.asarray(0, np.int32)),
                     total_spawned=to_array(np.asarray(0, np.int32)))


def test_render_particles_textured_alpha_and_zformula():
    """tests/test_sprites.py:216-254 through render_particles: the nearer
    red wins back to front, the later blue in plain draw order; both
    equal the JAX images at the bound."""
    tex = np.ones((8, 8), np.float32)
    kw = dict(texture=tex, size_bins=1, size_min=6.0, size_max=6.0,
              angle_bins=1, rank=2)
    cj, ct = _cfgs(4, 32, 32, capacity=16)
    js = _two_leaves(jrender, JState, jnp.asarray)
    ts = _two_leaves(render, ParticleState, torch.as_tensor)
    for zf, winner in (((0.0, 0.0, 1.0, 0.0), 0), (None, 2)):
        ref = np.asarray(jrender.render_particles(
            js, cj, appearance=jrender.ParticleAppearance(**kw),
            additive_blend=False, z_formula=zf)[0])
        img = render.render_particles(
            ts, ct, appearance=render.ParticleAppearance(**kw),
            additive_blend=False, z_formula=zf)[0].numpy()
        np.testing.assert_allclose(img, ref, rtol=0, atol=BOUND + 1e-3)
        c = img[16, 16]
        assert c[winner] > 0.9 and c[2 - winner] < 0.1, (zf, c)


def test_size_from_z_scales_size():
    """tests/test_sprites.py:257-269 through the port: size_from_z 0.5 at
    z 10 draws a far larger particle."""
    pos = torch.tensor([[8.0, 16.0, 0.0, 1.0], [24.0, 16.0, 10.0, 1.0]])
    st = ParticleState.empty(2, device="cpu").replace(
        position=pos, render_color=torch.ones(2, 4),
        render_data=torch.tensor([[2.0, 0, 0, 0], [2.0, 0, 0, 0]]))
    _, ct = _cfgs(4, 32, 32)
    img = render.render_particles(st, ct, size_from_z=0.5)[0].numpy()
    left = (img[:, :16, 0] > 0.01).sum()
    right = (img[:, 16:, 0] > 0.01).sum()
    assert right > left * 3, (left, right)


def test_sprite_apron_must_hold_the_support():
    tp = _tables("leaf_cell")[1]
    _, ct = _cfgs(4)
    args = [torch.zeros(2)] * 2 + [torch.ones(2, 4), torch.full((2,), 9.0),
                                   torch.ones(2, dtype=torch.bool)]
    with pytest.raises(ValueError, match="apron"):
        sprites.rasterize_sprites(ct, tp, *args)
    with pytest.raises(ValueError, match="apron"):
        sprites.rasterize_sprites_alpha(ct, tp, *args)
