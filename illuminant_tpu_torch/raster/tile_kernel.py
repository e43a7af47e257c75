"""Tile-raster kernels: the CUDA source `csrc/tile_raster.cu`, its wrappers
and their plain PyTorch versions.

Replaces two XLA stages of the JAX package, which has no Pallas kernel
here: `illuminant_tpu/raster/tiled.py:composite_over_tiles` (a lax.scan
over bin slots, every step "over"-compositing one slot of every tile) and
the tile splat of `illuminant_tpu/raster/sprites.py:rasterize_sprites`
(rank-R one-hot matmuls per tile and an overlap-add of the windows). Two
kernels, one wrapper each:
  * `composite_over_tiles` (K11a): the ordered "over" of each tile's
    binned particles in draw order, with an analytic profile or a sprite
    table's coverage, the Bayer dither and the background epilogue;
  * `sprite_accumulate` (K11b): the additive sprite coverage, each pixel
    summing the particles binned to its tile and its 8 neighbours whose
    windows cover it. The kernel first keeps only the neighbours'
    particles whose footprint meets its tile; `accumulate_filter_reference`
    mirrors that filter for the tests and `chip_smoke.py`.
Both take the bins of `tiled.bin_footprints` (particle indices grouped by
tile in draw order, and the (NT + 1,) starts) and (N, 8) float32 particle
records: x, y, four colour values, the profile radius, the variant id.

On a CPU tensor each wrapper runs its plain version; a CUDA tensor
launches the kernel or raises. The plain versions are what the kernels
compute, in the same operation order: the composite runs one step per bin
slot over the tiles whose list is that long, as the JAX scan does; the
splat scatters each particle's footprint with `index_add_`. The library is
compiled from the repository's source at first use (`core/cuda_build`).
"""

from __future__ import annotations

import ctypes

import torch

from ..core import cuda_build
# Read by tools/torch_tile_study.py, which builds variants of the source.
from ..core.cuda_build import NVCC_FLAGS, nvcc as _nvcc  # noqa: F401
from .tiled import (KERNEL_GAUSS, KERNEL_QUAD, KERNEL_ROUND,
                    TiledRasterConfig, _profile)

_SOURCE = cuda_build.CSRC / "tile_raster.cu"
_LIBRARY = cuda_build.library_path(_SOURCE)
# The kernels' coverage kinds, in the source's `Kind` order.
KINDS = {KERNEL_QUAD: 0, KERNEL_GAUSS: 1, KERNEL_ROUND: 2}
SPRITE = 3
MAX_TILE = 32
MAX_RANK = 64
RECORD = 8
# K11b packs a particle index and a 4-bit neighbour code in one int32.
CODE_BITS = 4
MAX_ACCUMULATE_PARTICLES = 1 << (31 - CODE_BITS)
_BAYER = ((0, 8, 2, 10), (12, 4, 14, 6), (3, 11, 1, 9), (15, 7, 13, 5))

# Launches since import (or since a caller reset them): each wrapper adds
# one where it launches its kernel and nowhere else.
COMPOSITE_LAUNCHES = 0   # composite_over_tiles (K11a)
ACCUMULATE_LAUNCHES = 0  # sprite_accumulate (K11b)
_lib = None


def build():
    """Compile csrc/tile_raster.cu unless an up-to-date library is there."""
    return cuda_build.build(_SOURCE, _LIBRARY)


def _library():
    global _lib
    if _lib is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        _lib = cuda_build.load(_SOURCE, _LIBRARY, {
            "tile_composite": [ptr, ptr, ptr, ptr, ptr, i32, i32, i32, ptr,
                               ptr, i32, i32, i32, i32, i32, i32, ptr],
            "tile_accumulate": [ptr, ptr, ptr, ptr, ptr, i32, i32, i32, ptr,
                                ctypes.c_longlong, ptr, i32, i32, i32, i32,
                                i32, ptr],
            "tile_plan": [i32, i32, i32, i32, ctypes.POINTER(ctypes.c_int)]})
    return _lib


def launch_plan(accumulate: bool, tile: int, ranks: int,
                table_floats: int) -> dict:
    """The block a launch of K11b (`accumulate`) or K11a takes at these
    sizes on the current card: threads, chunk, the table's floats held in
    shared memory (0: read from global memory), dynamic shared memory
    bytes, resident blocks an SM, registers and spilled bytes a thread.
    `table_floats`: 2 x B x R x S of a sprite table, 0 for a profile."""
    out = (ctypes.c_int * 7)()
    cuda_build.check(_library().tile_plan(int(accumulate), tile, ranks,
                                          table_floats, out), "tile_plan")
    return dict(zip(("threads", "chunk", "table_floats", "smem_bytes",
                     "blocks_per_sm", "registers", "spill_bytes"), out))


def _check(name: str, cfg: TiledRasterConfig, bins, records, table):
    ids, starts = bins
    gy, gx = cfg.grid
    if (ids.dim() != 1 or ids.dtype != torch.int32
            or starts.shape != (gy * gx + 1,) or starts.dtype != torch.int32):
        raise ValueError(f"{name}: bins must be int32 ids (M,) and starts "
                         f"({gy * gx + 1},), got {tuple(ids.shape)} "
                         f"{ids.dtype}, {tuple(starts.shape)} {starts.dtype}")
    if (records.dim() != 2 or records.shape[1] != RECORD
            or records.dtype != torch.float32):
        raise ValueError(f"{name}: records must be float32 (N, {RECORD}), "
                         f"got {records.dtype} {tuple(records.shape)}")
    if table is not None:
        rows, cols = table
        if (rows.dim() != 3 or rows.shape != cols.shape
                or rows.dtype != torch.float32
                or cols.dtype != torch.float32):
            raise ValueError(f"{name}: the sprite factors must be two "
                             "float32 (B, R, S) tensors")


def _launchable(name: str, cfg: TiledRasterConfig, tensors, ranks: int):
    """Raise unless the tensors share one CUDA device, are contiguous and
    the shapes are ones the kernel takes."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: the tensors must share a device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the tensors must be contiguous")
    if not (4 <= cfg.tile <= MAX_TILE and cfg.tile % 4 == 0
            and 0 <= cfg.apron <= cfg.tile and 1 <= ranks <= MAX_RANK):
        raise ValueError(f"{name}: the kernel takes a tile of 4 to "
                         f"{MAX_TILE} pixels (a multiple of 4), an apron "
                         f"up to the tile and 1 to {MAX_RANK} ranks; got "
                         f"tile {cfg.tile}, apron {cfg.apron}, {ranks}")


# --- the factors both plain versions share ------------------------------

def _axis_factors(cfg: TiledRasterConfig, rec, pos, org, w, coverage):
    """Factors of particles `rec` (m, 8) at window rows (or columns) `w`
    of their tiles' windows: pos (m,) the coordinate, org (m,) the window
    tile's origin on this axis, w (m, L) int64 window indices -> (m, R, L),
    0 outside the window. `coverage`: a kernel name, or a sprite table's
    (row or column) factors (B, R, S)."""
    a = cfg.apron
    inside = (w >= 0) & (w < cfg.window)
    if isinstance(coverage, str):
        d = (w.to(torch.float32) + 0.5) - ((pos - org) + a)[:, None]
        v = _profile(coverage, d, rec[:, 6:7])
        return torch.where(inside, v, 0.0)[:, None, :]
    s = coverage.shape[2]
    half = s // 2
    p = ((pos - org) + a) - 0.5
    fl = torch.floor(p)
    f = (p - fl)[:, None, None]
    dd = (w - fl.to(torch.int64)[:, None])[:, None, :]
    b = torch.clamp(rec[:, 7].to(torch.int64), 0, coverage.shape[0] - 1)
    fac = coverage[b]  # (m, R, S)
    out = []
    for tap, weight in ((dd - 1 + half, f), (dd + half, 1.0 - f)):
        ok = (tap >= 0) & (tap < s) & inside[:, None, :]
        idx = torch.clamp(tap, 0, s - 1).expand(-1, fac.shape[1], -1)
        out.append(torch.where(ok, weight * torch.gather(fac, 2, idx), 0.0))
    return out[0] + out[1]


def _coverage(wy, wx):
    """sum over ranks of wy_r (m, L_y) x wx_r (m, L_x), ranks in order."""
    cov = wy[:, 0, :, None] * wx[:, 0, None, :]
    for r in range(1, wy.shape[1]):
        cov = cov + wy[:, r, :, None] * wx[:, r, None, :]
    return cov


# --- K11a ---------------------------------------------------------------

def composite_over_tiles_reference(cfg: TiledRasterConfig, bins, records,
                                   coverage, background=None,
                                   dither: bool = False):
    """Plain version of the composite (tiled.py:749-822): slot j of every
    tile whose list is longer than j composites over that tile's pixels
    in one step, as the JAX scan does (tiles ordered by list length so
    the active ones are a prefix; the lengths are read back once). Each
    tile computes its own pixels only: the JAX package composites the
    whole window and keeps the same central crop."""
    ids, starts = bins
    gy, gx = cfg.grid
    t, a = cfg.tile, cfg.apron
    nt = gy * gx
    dev = records.device
    sprite = not isinstance(coverage, str)
    if dither and t % 4:
        raise ValueError("dither phase needs tile % 4 == 0")
    counts = (starts[1:] - starts[:-1]).to(torch.int64)
    by_len = torch.argsort(counts, descending=True, stable=True)
    lengths = counts[by_len].tolist()
    tile_ids = by_len
    first = starts[:-1].to(torch.int64)[tile_ids]
    oy = (tile_ids // gx * t).to(torch.float32)
    ox = (tile_ids % gx * t).to(torch.float32)
    w = torch.arange(a, a + t, device=dev)
    bayer = torch.tensor(_BAYER, dtype=torch.float32, device=dev) / 16.0
    bayer = bayer[(torch.arange(t, device=dev) % 4)[:, None],
                  (torch.arange(t, device=dev) % 4)[None, :]]
    img = torch.zeros((nt, t, t, 4), dtype=torch.float32, device=dev)
    m = nt
    for j in range(lengths[0] if nt else 0):
        while lengths[m - 1] <= j:
            m -= 1
        rec = records[ids[first[:m] + j].to(torch.int64)]
        rows = coverage if not sprite else coverage[0]
        cols = coverage if not sprite else coverage[1]
        wy = _axis_factors(cfg, rec, rec[:, 1], oy[:m], w.expand(m, -1), rows)
        wx = _axis_factors(cfg, rec, rec[:, 0], ox[:m], w.expand(m, -1), cols)
        cov = _coverage(wy, wx)
        if sprite:
            cov = torch.clamp(cov, 0.0, 1.0)
        a_eff = cov * rec[:, 5, None, None]
        if dither:
            a_eff = torch.where((a_eff > bayer) & (a_eff > 0.0), 1.0, 0.0)
        om = 1.0 - a_eff
        cur = img[:m]
        rgb = cur[..., :3] * om[..., None] + rec[:, None, None, 2:5] \
            * a_eff[..., None]
        acc = cur[..., 3] * om + a_eff
        img[:m] = torch.cat([rgb, acc[..., None]], dim=-1)
    tiles = torch.empty_like(img)
    tiles[tile_ids] = img
    out = tiles.reshape(gy, gx, t, t, 4).permute(0, 2, 1, 3, 4).reshape(
        gy * t, gx * t, 4)[:cfg.height, :cfg.width]
    if background is not None:
        acc_a = torch.clamp(out[..., 3:4], 0.0, 1.0)
        k = 1.0 - acc_a
        out = torch.cat([out[..., :3] + background[..., :3] * k,
                         acc_a + background[..., 3:4] * k], dim=-1)
    return out.contiguous()


def composite_over_tiles(cfg: TiledRasterConfig, bins, records, coverage,
                         background=None, dither: bool = False):
    """Ordered 'over' of each tile's binned particles in draw order
    (tiled.py:749-822; also `tiled.composite_over_tiles`) -> (H, W, 4):
    premultiplied rgb and accumulated alpha, over `background` (H, W, 4)
    if given. `bins` from `tiled.bin_footprints` with a support size,
    `records` from `tiled.alpha_records` (the sprite path puts the variant
    id in the last column), `coverage` a kernel name (tiled.KERNEL_*) or a
    sprite table's (row_factors, col_factors). `dither`: the 4 x 4 Bayer
    discard (fx:158-175). A CPU tensor runs the plain version; a CUDA
    tensor launches K11a on the current stream, or raises."""
    global COMPOSITE_LAUNCHES
    sprite = not isinstance(coverage, str)
    if not sprite and coverage not in KINDS:
        raise ValueError(f"unknown kernel {coverage!r}")
    _check("composite_over_tiles", cfg, bins, records,
           coverage if sprite else None)
    if background is not None:
        background = torch.broadcast_to(
            background.to(device=records.device, dtype=torch.float32),
            (cfg.height, cfg.width, 4))
    if records.device.type == "cpu":
        return composite_over_tiles_reference(cfg, bins, records, coverage,
                                              background, dither)
    ids, starts = bins
    rows, cols = coverage if sprite else (records, records)
    ranks = rows.shape[1] if sprite else 1
    if background is not None:
        background = background.contiguous()
    _launchable("composite_over_tiles", cfg,
                [records, ids, starts, rows, cols]
                + ([background] if background is not None else []), ranks)
    out = torch.empty((cfg.height, cfg.width, 4), dtype=torch.float32,
                      device=records.device)
    b, r, s = rows.shape if sprite else (1, 1, 1)
    with torch.cuda.device(records.device):
        err = _library().tile_composite(
            ids.data_ptr(), starts.data_ptr(), records.data_ptr(),
            rows.data_ptr(), cols.data_ptr(), b, r, s,
            background.data_ptr() if background is not None else None,
            out.data_ptr(), cfg.height, cfg.width, cfg.tile, cfg.apron,
            SPRITE if sprite else KINDS[coverage], int(bool(dither)),
            torch.cuda.current_stream(records.device).cuda_stream)
    cuda_build.check(err, "tile_composite")
    COMPOSITE_LAUNCHES += 1
    return out


# --- K11b ---------------------------------------------------------------

def sprite_accumulate_reference(cfg: TiledRasterConfig, bins, records,
                                table):
    """Plain version of the additive sprite splat (sprites.py:344-379):
    each binned particle's footprint, the S + 1 rows and columns around
    it, inside its own tile's window and the image, adds coverage x its
    first `cfg.channels` colour values with `index_add_`."""
    ids, starts = bins
    rows, cols = table
    gy, gx = cfg.grid
    t, a = cfg.tile, cfg.apron
    nt = gy * gx
    ch = cfg.channels
    dev = records.device
    s = rows.shape[2]
    half = s // 2
    pos = torch.arange(ids.shape[0], device=dev)
    tile = torch.searchsorted(starts[1:].to(torch.int64), pos, right=True)
    drawn = tile < nt
    tile = torch.clamp(tile, max=nt - 1)
    rec = records[ids.to(torch.int64)]
    oy = (tile // gx * t).to(torch.float32)
    ox = (tile % gx * t).to(torch.float32)
    k = torch.arange(s + 1, device=dev)

    def axis(p, org, fac, extent):
        lo = torch.floor(((p - org) + a) - 0.5).to(torch.int64) - half
        w = lo[:, None] + k  # window indices of the footprint
        f = _axis_factors(cfg, rec, p, org, w, fac)
        pix = org.to(torch.int64)[:, None] - a + w
        ok = (pix >= 0) & (pix < extent) & (w >= 0) & (w < cfg.window)
        return f, torch.clamp(pix, 0, extent - 1), ok

    wy, py, oky = axis(rec[:, 1], oy, rows, cfg.height)
    wx, px, okx = axis(rec[:, 0], ox, cols, cfg.width)
    img = torch.zeros((cfg.height * cfg.width, ch), dtype=torch.float32,
                      device=dev)
    color = rec[:, 2:2 + ch]
    for j in range(s + 1):
        cov = _coverage(wy[:, :, j:j + 1], wx)[:, 0]  # (n, S + 1)
        ok = drawn[:, None] & oky[:, j:j + 1] & okx
        contrib = torch.where(ok[..., None], cov[..., None]
                              * color[:, None, :], 0.0)
        img.index_add_(0, (py[:, j:j + 1] * cfg.width + px).reshape(-1),
                       contrib.reshape(-1, ch))
    return img.reshape(cfg.height, cfg.width, ch)


def sprite_accumulate(cfg: TiledRasterConfig, bins, records, table):
    """Additive sprite splat -> (H, W, cfg.channels): `bins` from
    `tiled.bin_footprints` without a support size (each particle in its own
    tile), `records` with the premultiplied colour in columns 2-5 and the
    variant id in column 7, `table` the sprite table's (row_factors,
    col_factors). A CPU tensor runs the plain version; a CUDA tensor
    launches K11b on the current stream, or raises."""
    _check("sprite_accumulate", cfg, bins, records, table)
    if not 1 <= cfg.channels <= 4:
        raise ValueError("sprite_accumulate: 1 to 4 channels")
    if records.device.type == "cpu":
        return sprite_accumulate_reference(cfg, bins, records, table)
    # The filter's kept entries: 9 slots of the lists' length.
    keep = torch.empty(9 * bins[0].shape[0], dtype=torch.int32,
                       device=records.device)
    return _accumulate(cfg, bins, records, table, keep)


def _accumulate(cfg: TiledRasterConfig, bins, records, table, keep):
    """Launch K11b with `keep` as its filter's scratch list."""
    global ACCUMULATE_LAUNCHES
    ids, starts = bins
    rows, cols = table
    _launchable("sprite_accumulate", cfg,
                [records, ids, starts, rows, cols, keep], rows.shape[1])
    if max(records.shape[0], ids.shape[0]) >= MAX_ACCUMULATE_PARTICLES:
        raise ValueError("sprite_accumulate: the kernel takes fewer than "
                         f"{MAX_ACCUMULATE_PARTICLES} particles")
    out = torch.empty((cfg.height, cfg.width, cfg.channels),
                      dtype=torch.float32, device=records.device)
    b, r, s = rows.shape
    with torch.cuda.device(records.device):
        err = _library().tile_accumulate(
            ids.data_ptr(), starts.data_ptr(), records.data_ptr(),
            rows.data_ptr(), cols.data_ptr(), b, r, s, keep.data_ptr(),
            ids.shape[0], out.data_ptr(), cfg.height, cfg.width, cfg.tile,
            cfg.apron, cfg.channels,
            torch.cuda.current_stream(records.device).cuda_stream)
    cuda_build.check(err, "tile_accumulate")
    ACCUMULATE_LAUNCHES += 1
    return out


def accumulate_kept(cfg: TiledRasterConfig, bins, records, table):
    """What K11b's filter kept, read back from its scratch list after one
    launch on the card, for the tests and `chip_smoke.py`: the entries
    its walk then reads, tile by tile, as `accumulate_filter_reference`
    gives them -> (kept (K,) int64 particle indices, starts (NT + 1,)
    int64, source (K,) int64 the tile each entry's code names). The
    scratch starts at -1; a block's kept entries of neighbour row r lie
    from where that row's lists begin in ids, in slot 3 r + tx % 3, and
    the walk reads as many as the slot holds there."""
    _check("accumulate_kept", cfg, bins, records, table)
    if records.device.type == "cpu":
        raise ValueError("accumulate_kept: the filter's list exists only "
                         "on the card")
    ids, starts = bins
    entries = ids.shape[0]
    keep = torch.full((9 * entries,), -1, dtype=torch.int32,
                      device=records.device)
    _accumulate(cfg, bins, records, table, keep)
    keep = keep.cpu().to(torch.int64)
    st = starts.cpu().to(torch.int64)
    gy, gx = cfg.grid
    ty = torch.arange(gy * gx) // gx
    tx = torch.arange(gy * gx) % gx
    r = torch.arange(3)
    sy = ty[:, None] + r - 1  # (NT, 3) the neighbour rows
    inside = (sy >= 0) & (sy < gy)
    row = torch.clamp(sy, 0, gy - 1) * gx
    begin = torch.where(inside, st[row + torch.clamp(tx - 1, min=0)[:, None]],
                        0)
    end = torch.where(inside, st[row + torch.clamp(tx + 1, max=gx - 1)[:, None]
                                 + 1], 0)
    base = (r * 3 + (tx % 3)[:, None]) * entries + begin
    held = torch.nn.functional.pad(torch.cumsum(keep >= 0, 0), (1, 0))
    count = (held[base + (end - begin)] - held[base]).reshape(-1)
    first = torch.repeat_interleave(base.reshape(-1), count)
    offset = torch.arange(int(count.sum())) - torch.repeat_interleave(
        torch.cumsum(count, 0) - count, count)
    v = keep[first + offset]
    code = v & ((1 << CODE_BITS) - 1)
    per_tile = count.reshape(gy * gx, 3).sum(1)
    block = torch.repeat_interleave(torch.arange(gy * gx), per_tile)
    source = ((block // gx + code // 3 - 1) * gx
              + block % gx + code % 3 - 1)
    kept_starts = torch.nn.functional.pad(torch.cumsum(per_tile, 0), (1, 0))
    return v >> CODE_BITS, kept_starts, source


def accumulate_filter_reference(cfg: TiledRasterConfig, bins, records,
                                support: int):
    """What K11b stages, in its order: for each tile, the entries of its
    own and its 8 neighbours' lists (neighbour row, then tile, then list
    order, which is the order of the entries in `ids`) whose footprint
    (the `support` + 1 window positions of `sprite_accumulate_reference`),
    clipped to their own tile's window and to the image, meets the tile.
    -> (kept (K,) int64 particle indices grouped by tile, starts (NT + 1,)
    int64, listed (NT,) int64 the entries of the 3 x 3 lists, which the
    kernel staged before it filtered)."""
    ids, starts = bins
    gy, gx = cfg.grid
    t, a = cfg.tile, cfg.apron
    nt = gy * gx
    dev = records.device
    half = support // 2
    n = int(starts[-1])
    pos = torch.arange(n, device=dev)
    src = torch.searchsorted(starts[1:].to(torch.int64), pos, right=True)
    sy, sx = src // gx, src % gx
    rec = records[ids[:n].to(torch.int64)]
    counts = (starts[1:] - starts[:-1]).to(torch.int64).reshape(gy, gx)
    padded = torch.nn.functional.pad(counts, (1, 1, 1, 1))
    listed = sum(padded[1 + dy:1 + dy + gy, 1 + dx:1 + dx + gx]
                 for dy in (-1, 0, 1) for dx in (-1, 0, 1)).reshape(-1)

    def meets(p, s_, own, extent):
        """Window positions lo .. lo + S of tile s_'s window, inside it
        and the image, that are lines of tile `own`."""
        lo = torch.floor(((p - (s_ * t).to(torch.float32)) + a)
                         - 0.5).to(torch.int64) - half
        wlo = torch.clamp(lo, min=0)
        whi = torch.clamp(lo + support, max=cfg.window - 1)
        w0 = a + (own - s_) * t
        llo = torch.clamp(wlo - w0, min=0)
        lhi = torch.minimum(torch.clamp(whi - w0, max=t - 1),
                            extent - 1 - own * t)
        return llo <= lhi

    tiles, entries = [], []
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            ty, tx = sy - dy, sx - dx  # the tile that sees src as (dy, dx)
            ok = (ty >= 0) & (ty < gy) & (tx >= 0) & (tx < gx)
            ok &= meets(rec[:, 1], sy, ty, cfg.height)
            ok &= meets(rec[:, 0], sx, tx, cfg.width)
            tiles.append((ty * gx + tx)[ok])
            entries.append(pos[ok])
    tile = torch.cat(tiles)
    entry = torch.cat(entries)
    order = torch.argsort(tile * max(n, 1) + entry)
    kept = ids[entry[order]].to(torch.int64)
    kept_starts = torch.searchsorted(tile[order],
                                     torch.arange(nt + 1, device=dev))
    return kept, kept_starts, listed
