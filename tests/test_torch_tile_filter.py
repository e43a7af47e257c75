"""The plain mirror of K11b's neighbour filter
(`tile_kernel.accumulate_filter_reference`) on the CPU.

K11b (`csrc/tile_raster.cu:accumulate_kernel`) stages, for each tile, only
the particles of its 3 x 3 neighbourhood whose footprint, clipped to their
own tile's window and to the image, meets the tile. These tests hold the
mirror to what the plain splat (`sprite_accumulate_reference`) draws: it
keeps every particle that gives the tile a nonzero pixel, exactly the
particles whose clipped footprint meets the tile, nothing from outside
the 3 x 3 neighbourhood, and the kernel's order (neighbour row, tile,
list). At 90 x 150 every tile size leaves partial tiles at the right and
bottom edges.
"""

import numpy as np
import pytest
import torch

from illuminant_tpu_torch.raster import sprites, tile_kernel, tiled

H, W = 90, 150


def _table():
    n = 16
    ys, xs = np.meshgrid(np.linspace(-1, 1, n), np.linspace(-1, 1, n),
                         indexing="ij")
    leaf = np.clip(1.0 - (np.abs(xs) ** 1.5 + np.abs(ys * 1.6) ** 1.5),
                   0, 1) ** 0.8
    return sprites.build_sprite_table(leaf.astype(np.float32),
                                      angle_bins=8, rank=4, size_bins=4,
                                      size_min=4.0, size_max=14.0,
                                      device="cpu")


def _scene(tile, seed=0, n=120):
    """Particles over the frame and past its edges, and particles that
    straddle tile corners, tile edges and the image's edges and corners:
    (cfg, bins, records, table)."""
    table = _table()
    cfg = tiled.TiledRasterConfig(height=H, width=W, tile=tile,
                                  apron=table.support // 2, channels=4)
    rng = np.random.default_rng(seed)
    x = list(rng.uniform(-8, W + 8, n))
    y = list(rng.uniform(-8, H + 8, n))
    for k in range(1, 4):  # tile corners and edges, inside and out
        for d in (-0.6, 0.0, 0.4, 1.5, -3.0):
            x.append(k * tile + d)
            y.append(k * tile - d)
            x.append(k * tile + d)
            y.append(rng.uniform(0, H))
    for cx, cy in ((0.2, 0.3), (W - 0.3, 0.1), (-2.0, H - 0.5),
                   (W + 3.0, H + 2.0), (W - 1.0, H * 0.5)):
        x.append(cx)
        y.append(cy)
    m = len(x)
    t = (lambda v: torch.as_tensor(np.asarray(v), dtype=torch.float32))
    x, y = t(x), t(y)
    size = t(rng.uniform(2.0, 14.0, m))
    rot = t(rng.uniform(0, 2 * np.pi, m))
    live = torch.as_tensor(rng.uniform(size=m) < 0.9)
    color = t(rng.uniform(0.1, 1.0, (m, 4)))
    variant = sprites.select_bins(table, torch.zeros_like(x), rot, size)
    records = torch.cat([x[:, None], y[:, None], color,
                         torch.zeros_like(x)[:, None],
                         variant.to(torch.float32)[:, None]], dim=1)
    bins = tiled.bin_footprints(cfg, x, y, live)
    return cfg, bins, records, table


def _kept_by_tile(cfg, bins, records, table):
    kept, starts, listed = tile_kernel.accumulate_filter_reference(
        cfg, bins, records, table.support)
    nt = cfg.grid[0] * cfg.grid[1]
    assert starts.shape == (nt + 1,) and listed.shape == (nt,)
    return [kept[starts[i]:starts[i + 1]].tolist() for i in range(nt)], \
        listed


def _source_tiles(cfg, bins):
    """Each listed particle's own tile."""
    ids, starts = bins
    own = {}
    for tile in range(cfg.grid[0] * cfg.grid[1]):
        for pid in ids[starts[tile]:starts[tile + 1]].tolist():
            own[pid] = tile
    return own


@pytest.mark.parametrize("tile", [8, 12, 32])
def test_filter_keeps_every_particle_the_splat_draws(tile):
    """For each particle alone, the plain splat's nonzero pixels lie in
    tiles whose kept list holds that particle."""
    cfg, bins, records, table = _scene(tile)
    kept, _ = _kept_by_tile(cfg, bins, records, table)
    gx = cfg.grid[1]
    nt = cfg.grid[0] * gx
    checked = 0
    for pid, own in _source_tiles(cfg, bins).items():
        # The bins of this particle alone, in its own tile.
        one = (torch.tensor([pid], dtype=torch.int32),
               torch.tensor([0] * (own + 1) + [1] * (nt - own),
                            dtype=torch.int32))
        img = tile_kernel.sprite_accumulate_reference(
            cfg, one, records, (table.row_factors, table.col_factors))
        py, px = torch.nonzero(img.abs().sum(-1) > 0, as_tuple=True)
        for t_ in set(((py // tile) * gx + px // tile).tolist()):
            assert pid in kept[t_], (pid, t_)
            checked += 1
    assert checked > len(_source_tiles(cfg, bins))  # many reach a neighbour


@pytest.mark.parametrize("tile", [8, 12, 32])
def test_filter_is_the_splats_window_test_in_kernel_order(tile):
    """Each tile's kept list equals, in order, the entries of its 3 x 3
    neighbours' lists (dy, then dx, then list order) whose footprint
    window positions, inside their own tile's window and the image, land
    on the tile's pixels: the splat's `ok` mask, here in plain loops. So
    nothing comes from outside the neighbourhood, and the filter drops
    most of what the unfiltered kernel staged."""
    cfg, bins, records, table = _scene(tile, seed=1)
    kept, listed = _kept_by_tile(cfg, bins, records, table)
    ids, starts = bins
    gy, gx = cfg.grid
    a, s = cfg.apron, table.support
    rec = records.numpy()

    def tiles_hit(pid, src):
        """The tiles of the pixels that the splat may write for particle
        pid binned to tile src."""
        out = []
        for axis, org, extent in ((1, src // gx * tile, H),
                                  (0, src % gx * tile, W)):
            p = np.float32(np.float32(rec[pid, axis] - np.float32(org))
                           + np.float32(a)) - np.float32(0.5)
            lo = int(np.floor(p)) - s // 2
            pix = [org - a + w for w in range(lo, lo + s + 1)
                   if 0 <= w < cfg.window and 0 <= org - a + w < extent]
            out.append({v // tile for v in pix})
        return {ty * gx + tx for ty in out[0] for tx in out[1]}

    own = _source_tiles(cfg, bins)
    for t_ in range(gy * gx):
        ty, tx = divmod(t_, gx)
        expect = []
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                sy, sx = ty + dy, tx + dx
                if not (0 <= sy < gy and 0 <= sx < gx):
                    continue
                src = sy * gx + sx
                for pid in ids[starts[src]:starts[src + 1]].tolist():
                    if t_ in tiles_hit(pid, src):
                        expect.append(pid)
        assert kept[t_] == expect, t_
        for pid in kept[t_]:
            sy, sx = divmod(own[pid], gx)
            assert abs(sy - ty) <= 1 and abs(sx - tx) <= 1
    total = sum(len(k) for k in kept)
    assert 0 < total < int(listed.sum())


def test_filter_counts_what_the_kernel_listed():
    """`listed` is the length of the 3 x 3 lists the unfiltered kernel
    staged: the sum of the neighbours' counts, edge tiles having fewer
    neighbours."""
    cfg, bins, records, table = _scene(32, seed=2)
    _, listed = _kept_by_tile(cfg, bins, records, table)
    _, starts = bins
    gy, gx = cfg.grid
    counts = (starts[1:] - starts[:-1]).reshape(gy, gx).tolist()
    for ty in range(gy):
        for tx in range(gx):
            want = sum(counts[sy][sx]
                       for sy in range(max(ty - 1, 0), min(ty + 2, gy))
                       for sx in range(max(tx - 1, 0), min(tx + 2, gx)))
            assert int(listed[ty * gx + tx]) == want
