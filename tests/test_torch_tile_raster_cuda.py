"""The tile-raster kernels (K11a composite, K11b sprite splat) on the card
against their plain versions.

This file imports neither jax nor the JAX package, so that it runs where
the card is:

    python -m pytest --noconftest -m cuda tests/test_torch_tile_raster_cuda.py

(`tests/conftest.py` configures jax; `--noconftest` leaves it out). Here,
without a card, the `cuda` cases skip and the CPU cases check that the
inputs reach what the card cases are about.

Tolerances: the source is compiled with -fmad=false in the plain
versions' operation order, so the composite equals its plain version bit
for bit; the additive splat sums each pixel's particles in another order
than the plain version's scatter, so it is held to float32 reordering:
1e-5 of (1 + the largest value of the image).
"""

import numpy as np
import pytest
import torch

from illuminant_tpu_torch.raster import sprites, tile_kernel, tiled

H, W = 96, 160


def _particles(n, seed, hot=0, device="cpu"):
    """n particles over the frame and past its edges, with opaque pairs
    straddling every tile border, and `hot` more inside one tile."""
    rng = np.random.default_rng(seed)
    x = list(rng.uniform(-4, W + 4, n))
    y = list(rng.uniform(-4, H + 4, n))
    for b in (32.0, 64.0, 96.0, 128.0):
        x += [b - 2.5, b + 2.0, b - 0.25]
        y += [40.0, 40.0, b * 0.5]
    x += list(rng.uniform(66, 94, hot))
    y += list(rng.uniform(34, 62, hot))
    m = len(x)
    a = rng.uniform(0.3, 1.0, m)
    a[n:n + 12] = 1.0
    st = rng.uniform(0.1, 1.0, (m, 3))
    color = np.concatenate([st * a[:, None], a[:, None]], axis=1)
    size = rng.uniform(1.0, 14.0, m)
    live = rng.uniform(size=m) < 0.9
    live[n:] = True
    t = (lambda v, dt=torch.float32: torch.as_tensor(
        np.asarray(v), dtype=dt, device=device))
    return (t(x), t(y), t(color), t(size), t(live, torch.bool),
            t(rng.uniform(0, 2 * np.pi, m)))


def _table(device):
    n = 16
    ys, xs = np.meshgrid(np.linspace(-1, 1, n), np.linspace(-1, 1, n),
                         indexing="ij")
    leaf = np.clip(1.0 - (np.abs(xs) ** 1.5 + np.abs(ys * 1.6) ** 1.5),
                   0, 1) ** 0.8
    return sprites.build_sprite_table(leaf.astype(np.float32),
                                      angle_bins=8, rank=4, size_bins=4,
                                      size_min=4.0, size_max=14.0,
                                      device=device)


def _counts(cfg, x, y, live, support_size):
    ids, starts = tiled.bin_footprints(cfg, x, y, live, support_size)
    return (starts[1:] - starts[:-1]).numpy(), ids


def test_inputs_cross_tiles_and_fill_a_hot_tile():
    """On the CPU: particles land in more than one tile, one tile lists
    more than 1024 (more than one chunk of the kernel at any rank), and
    the bins keep draw order inside every tile."""
    cfg = tiled.TiledRasterConfig(height=H, width=W, apron=7)
    x, y, _, size, live, _ = _particles(400, 0, hot=1100)
    counts, ids = _counts(cfg, x, y, live, size)
    assert counts.max() > 1024
    assert counts.sum() > int(live.sum())  # replicated across borders
    start = 0
    for c in counts:
        seg = ids[start:start + c].numpy()
        assert (np.diff(seg) > 0).all()
        start += c


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")


def _alpha(cfg, x, y, color, size, live, rotation, table):
    """The alpha route's bins and records, at opacity 0.8."""
    bins = tiled.bin_footprints(cfg, x, y, live,
                                size if table is None
                                else torch.clamp(size, max=2.0
                                                 * table.support))
    rec = tiled.alpha_records(cfg, x, y, color, size, opacity=0.8)
    if table is not None:
        rec[:, 7] = sprites.select_bins(
            table, torch.zeros_like(x), rotation, size).to(torch.float32)
    return bins, rec


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["quad", "gauss", "round", "sprite"])
@pytest.mark.parametrize("dither", [False, True])
def test_cuda_composite_equals_plain(kernel, dither):
    """K11a over cross-tile overlaps and a hot tile of more than 1024
    particles, with and without dither, over a background: bitwise."""
    _needs_card()
    cfg = tiled.TiledRasterConfig(height=H, width=W, apron=7,
                                  kernel="quad" if kernel == "sprite"
                                  else kernel)
    x, y, color, size, live, rot = _particles(400, 1, hot=1100,
                                              device="cuda")
    table = _table("cuda") if kernel == "sprite" else None
    bins, rec = _alpha(cfg, x, y, color, size, live, rot, table)
    coverage = ((table.row_factors, table.col_factors) if table is not None
                else kernel)
    bg = torch.rand((H, W, 4), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(3))
    before = tile_kernel.COMPOSITE_LAUNCHES
    out = tile_kernel.composite_over_tiles(cfg, bins, rec, coverage, bg,
                                           dither)
    torch.cuda.synchronize()
    assert tile_kernel.COMPOSITE_LAUNCHES == before + 1
    ref = tile_kernel.composite_over_tiles_reference(cfg, bins, rec,
                                                     coverage, bg, dither)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert float(out[..., 3].max()) <= 1.0 + 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["quad", "sprite"])
@pytest.mark.parametrize("tile", [4, 8, 12])
def test_cuda_composite_small_tiles(tile, kernel):
    """K11a at tiles below 32 px: the chunk keeps the block's shared
    memory within the 48 KB a launch takes without an opt-in (tile 4 at
    rank 1 would need more), and 12 px tiles leave a partial tile at the
    right edge. Bitwise, as above."""
    _needs_card()
    cfg = tiled.TiledRasterConfig(height=H, width=W, tile=tile,
                                  apron=min(4, tile), kernel="quad")
    x, y, color, size, live, rot = _particles(400, 5, hot=300,
                                              device="cuda")
    table = _table("cuda") if kernel == "sprite" else None
    bins, rec = _alpha(cfg, x, y, color, size, live, rot, table)
    coverage = ((table.row_factors, table.col_factors) if table is not None
                else kernel)
    out = tile_kernel.composite_over_tiles(cfg, bins, rec, coverage,
                                           dither=True)
    ref = tile_kernel.composite_over_tiles_reference(cfg, bins, rec,
                                                     coverage, dither=True)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("channels", [3, 4])
def test_cuda_sprite_accumulate_matches_plain(channels):
    """K11b over windows that cross tile borders and a hot tile: each
    pixel's sum equals the plain scatter's to float32 reordering."""
    _needs_card()
    cfg = tiled.TiledRasterConfig(height=H, width=W, apron=7,
                                  channels=channels)
    x, y, color, size, live, rot = _particles(400, 2, hot=1100,
                                              device="cuda")
    table = _table("cuda")
    before = tile_kernel.ACCUMULATE_LAUNCHES
    out, _ = sprites.rasterize_sprites(cfg, table, x, y, color, size, live,
                                       rotation=rot)
    torch.cuda.synchronize()
    assert tile_kernel.ACCUMULATE_LAUNCHES == before + 1
    bins = tiled.bin_footprints(cfg, x, y, live)
    rec = torch.cat([x[:, None], y[:, None], color,
                     torch.zeros_like(x)[:, None],
                     sprites.select_bins(table, torch.zeros_like(x), rot,
                                         size).to(torch.float32)[:, None]],
                    dim=1)
    ref = tile_kernel.sprite_accumulate_reference(
        cfg, bins, rec, (table.row_factors, table.col_factors))
    tol = 1e-5 * (1.0 + float(ref.abs().max()))
    torch.testing.assert_close(out, ref, rtol=0, atol=tol)


@pytest.mark.cuda
def test_cuda_kernels_refuse_mixed_devices():
    """A wrapper given tensors on two devices raises instead of falling
    back to the plain version."""
    _needs_card()
    cfg = tiled.TiledRasterConfig(height=H, width=W)
    x, y, color, size, live, _ = _particles(50, 4)
    bins = tiled.bin_footprints(cfg, x, y, live, size)
    rec = tiled.alpha_records(cfg, x, y, color, size).cuda()
    with pytest.raises(ValueError):
        tile_kernel.composite_over_tiles(cfg, bins, rec, "quad")
