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
    """K11a at tiles below 32 px: blocks of a warp or two whose threads
    do not all own pixels (tile 4: 4 of 32), and 12 px tiles leave a
    partial tile at the right edge. Bitwise, as above."""
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


def _hot_tile(n, hot, tile, seed, device="cuda"):
    """`_particles` with `hot` more whose centres lie inside the tile at
    (row 1, column 2) of a `tile`-px grid."""
    x, y, color, size, live, rot = _particles(n, seed, device=device)
    rng = np.random.default_rng(seed + 100)
    t = (lambda v: torch.as_tensor(v, dtype=torch.float32, device=device))
    a = rng.uniform(0.3, 1.0, hot)
    st = rng.uniform(0.1, 1.0, (hot, 3))
    return (torch.cat([x, t(rng.uniform(2 * tile, 3 * tile, hot))]),
            torch.cat([y, t(rng.uniform(tile, 2 * tile, hot))]),
            torch.cat([color, t(np.concatenate([st * a[:, None],
                                                a[:, None]], 1))]),
            torch.cat([size, t(rng.uniform(1.0, 14.0, hot))]),
            torch.cat([live, torch.ones(hot, dtype=torch.bool,
                                        device=device)]),
            torch.cat([rot, t(rng.uniform(0, 2 * np.pi, hot))]))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["quad", "sprite"])
@pytest.mark.parametrize("tile", [4, 8, 12, 16, 32])
@pytest.mark.parametrize("dither", [False, True])
def test_cuda_composite_long_list(tile, kernel, dither):
    """K11a on a tile of several thousand entries: a hundred and more
    chunks, so the three record and two factor buffers turn over many
    times, over a background, bitwise."""
    _needs_card()
    cfg = tiled.TiledRasterConfig(height=H, width=W, tile=tile,
                                  apron=min(7, tile), kernel="quad")
    x, y, color, size, live, rot = _hot_tile(300, 4500, tile, 6)
    table = _table("cuda") if kernel == "sprite" else None
    bins, rec = _alpha(cfg, x, y, color, size, live, rot, table)
    # A support box lists a particle in the up to 2 x 2 tiles it touches,
    # not always in the tile of its centre.
    counts = bins[1][1:] - bins[1][:-1]
    assert int(counts.max()) >= 2500
    coverage = ((table.row_factors, table.col_factors) if table is not None
                else kernel)
    bg = torch.rand((H, W, 4), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(7))
    out = tile_kernel.composite_over_tiles(cfg, bins, rec, coverage, bg,
                                           dither)
    ref = tile_kernel.composite_over_tiles_reference(cfg, bins, rec,
                                                     coverage, bg, dither)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [8, 12, 32])
@pytest.mark.parametrize("channels", [3, 4])
def test_cuda_sprite_accumulate_filtered_and_repeatable(tile, channels):
    """K11b with a hot tile of thousands of entries, whose particles also
    straddle into the neighbours' windows: within float32 reordering of
    its plain version, and two calls equal bit for bit (each pixel sums
    in a fixed order)."""
    _needs_card()
    cfg = tiled.TiledRasterConfig(height=H, width=W, tile=tile,
                                  apron=7, channels=channels)
    x, y, color, size, live, rot = _hot_tile(400, 3000, tile, 8)
    table = _table("cuda")
    first, _ = sprites.rasterize_sprites(cfg, table, x, y, color, size,
                                         live, rotation=rot)
    second, _ = sprites.rasterize_sprites(cfg, table, x, y, color, size,
                                          live, rotation=rot)
    bins = tiled.bin_footprints(cfg, x, y, live)
    rec = torch.cat([x[:, None], y[:, None], color,
                     torch.zeros_like(x)[:, None],
                     sprites.select_bins(table, torch.zeros_like(x), rot,
                                         size).to(torch.float32)[:, None]],
                    dim=1)
    ref = tile_kernel.sprite_accumulate_reference(
        cfg, bins, rec, (table.row_factors, table.col_factors))
    tol = 1e-5 * (1.0 + float(ref.abs().max()))
    torch.testing.assert_close(first, ref, rtol=0, atol=tol)
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("tile,height,width", [
    (8, H, W), (12, H, W), (32, H, W),
    # 24 x 44 tiles of 8 px: more than the 16 a thread that the blocks
    # scan to order the tiles, so they take them in screen order.
    (8, 192, 352)])
def test_cuda_accumulate_keeps_what_the_mirror_keeps(tile, height, width):
    """What K11b's filter kept, read back from its scratch list, equals
    the plain mirror (`accumulate_filter_reference`) entry for entry and
    in order, with a hot tile of thousands of entries; each entry's code
    names the tile the particle is binned to."""
    _needs_card()
    cfg = tiled.TiledRasterConfig(height=height, width=width, tile=tile,
                                  apron=7, channels=4)
    x, y, color, size, live, rot = _hot_tile(400, 3000, tile, 9)
    table = _table("cuda")
    bins = tiled.bin_footprints(cfg, x, y, live)
    rec = torch.cat([x[:, None], y[:, None], color,
                     torch.zeros_like(x)[:, None],
                     sprites.select_bins(table, torch.zeros_like(x), rot,
                                         size).to(torch.float32)[:, None]],
                    dim=1)
    kept, starts, source = tile_kernel.accumulate_kept(
        cfg, bins, rec, (table.row_factors, table.col_factors))
    want, want_starts, listed = tile_kernel.accumulate_filter_reference(
        cfg, bins, rec, table.support)
    assert torch.equal(starts, want_starts.cpu())
    assert torch.equal(kept, want.cpu())
    ids, bin_starts = bins
    n = int(bin_starts[-1])
    own = torch.empty(rec.shape[0], dtype=torch.int64, device="cuda")
    own[ids[:n].long()] = torch.searchsorted(
        bin_starts[1:].long(), torch.arange(n, device="cuda"), right=True)
    assert torch.equal(source, own[want].cpu())
    assert int(starts[-1]) < int(listed.sum())


def _big_table(device):
    """A table of 128 variants at rank 8: 2 x 128 x 8 x 15 floats, more
    than the kernels keep in shared memory."""
    n = 16
    ys, xs = np.meshgrid(np.linspace(-1, 1, n), np.linspace(-1, 1, n),
                         indexing="ij")
    leaf = np.clip(1.0 - (np.abs(xs) ** 1.5 + np.abs(ys * 1.6) ** 1.5),
                   0, 1) ** 0.8
    return sprites.build_sprite_table(leaf.astype(np.float32),
                                      angle_bins=32, rank=8, size_bins=4,
                                      size_min=4.0, size_max=14.0,
                                      device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("big", [False, True])
def test_cuda_table_in_shared_or_global_memory(big):
    """The leaf table at 32-px tiles takes the path above 48 KB of shared
    memory (the table copied into it, the launch opted in); a table too
    large for it is read from global memory. Both kernels agree with
    their plain versions on either path."""
    _needs_card()
    table = _big_table("cuda") if big else _table("cuda")
    floats = 2 * table.row_factors.numel()
    for accumulate in (False, True):
        plan = tile_kernel.launch_plan(accumulate, 32, table.rank, floats)
        if big:
            assert plan["table_floats"] == 0
        else:
            assert plan["table_floats"] == floats
            assert plan["smem_bytes"] > 48 * 1024
        assert plan["blocks_per_sm"] >= 2, plan
        assert plan["spill_bytes"] == 0, plan
    cfg = tiled.TiledRasterConfig(height=H, width=W, apron=7)
    x, y, color, size, live, rot = _hot_tile(400, 1500, 32, 9)
    bins, rec = _alpha(cfg, x, y, color, size, live, rot, table)
    coverage = (table.row_factors, table.col_factors)
    bg = torch.rand((H, W, 4), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(5))
    out = tile_kernel.composite_over_tiles(cfg, bins, rec, coverage, bg)
    ref = tile_kernel.composite_over_tiles_reference(cfg, bins, rec,
                                                     coverage, bg)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    add, _ = sprites.rasterize_sprites(cfg, table, x, y, color, size, live,
                                       rotation=rot)
    bins = tiled.bin_footprints(cfg, x, y, live)
    rec = torch.cat([x[:, None], y[:, None], color,
                     torch.zeros_like(x)[:, None],
                     sprites.select_bins(table, torch.zeros_like(x), rot,
                                         size).to(torch.float32)[:, None]],
                    dim=1)
    ref = tile_kernel.sprite_accumulate_reference(cfg, bins, rec, coverage)
    torch.testing.assert_close(add, ref, rtol=0,
                               atol=1e-5 * (1.0 + float(ref.abs().max())))


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
