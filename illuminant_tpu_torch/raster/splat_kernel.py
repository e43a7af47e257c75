"""The additive particle splat on the card: the CUDA source `csrc/splat.cu`
(K5), its wrapper, its launch plan and the plain mirrors of its binning.

K5 replaces the device work of `illuminant_tpu/raster/tiled.py:
rasterize_tiled` (:589) and, in the port, the plain direct splat
`raster/tiled.py:rasterize_tiled_reference`, which is its plain version.
Each particle adds only inside its own screen tile's window, so the
kernel bins the particles by tile (`bin_plan` is the plan's plain
version: each slot's tile, the counts, the offsets and the chunk table),
writes them in tile order, and accumulates each chunk of a tile's list
in that tile's window in shared memory, one block a chunk, before adding
the window to the image (`splat_binned_reference` is that accumulation in
PyTorch; a tile of at most DIRECT particles adds to the image directly). A call reads nothing back (the plain version's `nonzero` and
`amax` are two host reads) and never drops a particle. The source's
header says what bounds it and what the design does about it.

`splat_cuda` launches the kernels on CUDA tensors or raises; `launch_plan`,
`bin_plan` and `splat_binned_reference` are pure and run on the CPU. The
library is compiled from the repository's source at first use
(`core/cuda_build`).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core import cuda_build
from . import tiled

_i64p, _intp = ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int)
LIBRARY = cuda_build.Library("splat.cu", {
    "splat": [ctypes.POINTER(ctypes.c_void_p), _i64p, _i64p, _intp,
              ctypes.c_void_p],
    "splat_plan": [ctypes.c_int] * 4 + [_intp]}, ["k5_splat"])

# The source's Kind.
KERNELS = {"point": 0, "quad": 1, "gauss": 2, "round": 3}
# Kernel launches of one splat: bin, scan, scatter, accumulate.
LAUNCHES_PER_SPLAT = 4
# The most particles of a tile's list that one accumulation block takes (a
# chunk; `chunk_size`).
CHUNK = 256
# A tile of at most this many particles skips the shared-memory window:
# its terms go to the image directly, an atomic each.
DIRECT = 32
# Lanes that share a particle in the accumulation, a row of its footprint
# each: the gauss profile reaches twice as far as the others, so its
# footprints have about twice the rows (tools/torch_march_study.py).
LANES = {"point": 2, "quad": 2, "gauss": 4, "round": 2}
# The source's kThreads: every launch's block, and the most particles an
# accumulation block stages at a time (a batch).
THREADS = 256
# A batch holds THREADS particles, fewer where the window, their headers
# and profiles would take a block's shared memory past this (four blocks
# an SM fit).
BATCH_SMEM_BYTES = 56 * 1024
# Dynamic shared memory a block can use on an H100.
MAX_SMEM_BYTES = 232448


def support_taps(kernel: str, radius):
    """The half-width k in taps that the kernel walks for each radius
    (float32 tensor): ceil(_support(kernel, radius)) + 1, its support in
    float32 as the source computes it. Every tap with a nonzero profile
    lies within k of the particle's floor."""
    if kernel == "point":
        s = torch.ones_like(radius)
    elif kernel == "gauss":
        s = 4.0 * torch.clamp(radius * 0.5, min=0.3)
    else:
        s = radius + 0.5
    return torch.ceil(s).to(torch.int64) + 1


def profile_taps(cfg) -> int:
    """The most taps a profile spans inside a window: 2k + 1 for the
    largest radius (apron + 0.5, where `support_taps` peaks), at most the
    window's side. In float32 on the host, without a tensor."""
    r = np.float32(cfg.apron + 0.5)
    if cfg.kernel == "point":
        s = np.float32(1.0)
    elif cfg.kernel == "gauss":
        s = np.float32(4.0) * max(r * np.float32(0.5), np.float32(0.3))
    else:
        s = r + np.float32(0.5)
    return min(cfg.tile + 2 * cfg.apron, 2 * (int(np.ceil(s)) + 1) + 1)


def accumulate_smem(batch: int, taps: int, side: int, channels: int) -> int:
    """The accumulation's dynamic shared memory (the source's
    accumulate_smem): the side^2 window of C floats a pixel, each row 4
    floats longer, then a batch's headers (40 bytes a particle) and
    profiles (2 x taps floats a particle)."""
    window = side * (side * channels + 4)
    return 4 * window + batch * (16 + 16 + 8) + 4 * batch * 2 * taps


def batch_size(cfg) -> int:
    """Particles a batch holds for `cfg`: THREADS, halved while their
    staging takes a block past BATCH_SMEM_BYTES (down to 32)."""
    taps, batch = profile_taps(cfg), THREADS
    side = cfg.tile + 2 * cfg.apron
    while batch > 32 and accumulate_smem(batch, taps, side, cfg.channels) \
            > BATCH_SMEM_BYTES:
        batch //= 2
    return batch


def chunk_size(cfg) -> int:
    """Particles a chunk holds for `cfg`: CHUNK, or two batches where a
    batch is smaller (wide aprons), so that a clustered tile of a sparse
    frame spreads over more blocks."""
    return min(CHUNK, 2 * batch_size(cfg))


def launch_plan(cfg, x, y, color, size, live) -> dict:
    """Everything a K5 splat is given, from `rasterize_tiled`'s arguments
    (cfg a TiledRasterConfig): the particle count, each argument's
    element stride (`strides`: x, y, size, live, colour row, colour
    column), the source's `ints` (n, height, width, tile, apron, grid_y,
    grid_x, channels, kernel, chunk, batch, taps, DIRECT, lanes), the
    tiles, the accumulation's blocks, the scratch's element counts
    (`scratch`: bins, slots, records), and the accumulation's chunk
    (`chunk_size`), batch (`batch_size`), profile taps and shared memory.
    Pure: no kernel, no host read."""
    if cfg.kernel not in KERNELS:
        raise ValueError(f"unknown kernel {cfg.kernel!r}")
    n = x.shape[0]
    for name, t in (("x", x), ("y", y), ("size", size), ("live", live)):
        if t.dim() != 1 or t.shape[0] != n:
            raise ValueError(f"splat: {name} must be (N,), got "
                             f"{tuple(t.shape)}")
        if name != "live" and t.dtype != torch.float32:
            raise ValueError(f"splat: {name} must be float32, got {t.dtype}")
    if live.dtype != torch.bool:
        raise ValueError(f"splat: live must be bool, got {live.dtype}")
    if color.dim() != 2 or color.shape[0] != n or \
            color.shape[1] < cfg.channels or color.dtype != torch.float32:
        raise ValueError(f"splat: color must be float32 (N, >= "
                         f"{cfg.channels}), got {color.dtype} "
                         f"{tuple(color.shape)}")
    if not 1 <= cfg.channels <= 4:
        raise ValueError(f"splat: 1 to 4 channels, got {cfg.channels}")
    if n >= 2 ** 30:
        raise ValueError(f"splat: at most 2^30 particles, got {n}")
    chunk = chunk_size(cfg)
    if chunk < 1:
        raise ValueError(f"splat: CHUNK must be positive, got {chunk}")
    batch, taps = batch_size(cfg), profile_taps(cfg)
    smem = accumulate_smem(batch, taps, cfg.tile + 2 * cfg.apron,
                           cfg.channels)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"splat: {taps}-tap profiles need {smem} bytes of "
                         f"shared memory, more than {MAX_SMEM_BYTES}")
    gy, gx = cfg.grid
    tiles = gy * gx
    return dict(
        n=n, tiles=tiles, smem_bytes=smem, chunk=chunk, batch=batch,
        taps=taps,
        strides=[x.stride(0), y.stride(0), size.stride(0), live.stride(0),
                 color.stride(0), color.stride(1)],
        ints=[n, cfg.height, cfg.width, cfg.tile, cfg.apron, gy, gx,
              cfg.channels, KERNELS[cfg.kernel], chunk, batch, taps,
              DIRECT, LANES[cfg.kernel]],
        blocks=-(-n // chunk) + tiles,
        scratch=dict(bins=tiles + 2 * (tiles + 1) + -(-n // chunk) + tiles,
                     slots=2 * n, records=8 * n))


def splat_cuda(cfg, x, y, color, size, live, debug: bool = False):
    """One K5 splat on the current stream -> the (H, W, C) float32 image
    (`debug`: and the bins the kernels made: `counts`, `offsets` and
    `chunk_offsets` as `bin_plan` gives them). CUDA tensors only; views of
    any stride are read in place."""
    plan = launch_plan(cfg, x, y, color, size, live)
    dev = x.device
    if dev.type != "cuda" or any(t.device != dev
                                 for t in (y, color, size, live)):
        raise ValueError(f"splat_cuda: no kernel for device {dev} (every "
                         "tensor must lie on one CUDA device)")
    scratch = plan["scratch"]
    bins = torch.empty(scratch["bins"], dtype=torch.int32, device=dev)
    img = torch.zeros((cfg.height, cfg.width, cfg.channels),
                      dtype=torch.float32, device=dev)
    if plan["n"] == 0:
        return (img, _bins_view(bins.zero_(), plan)) if debug else img
    slots = torch.empty(scratch["slots"], dtype=torch.int32, device=dev)
    records = torch.empty(scratch["records"], dtype=torch.float32,
                          device=dev)
    ptr_list = [t.data_ptr() for t in (x, y, size, live, color, img, bins,
                                       slots, records)]
    ptrs = (ctypes.c_void_p * len(ptr_list))(*ptr_list)
    strides = (ctypes.c_longlong * 6)(*plan["strides"])
    ints = (ctypes.c_longlong * len(plan["ints"]))(*plan["ints"])
    LIBRARY.launch("k5_splat", "splat", dev, ptrs, strides, ints,
                   reports=True)
    return (img, _bins_view(bins, plan)) if debug else img


def _bins_view(bins, plan) -> dict:
    t = plan["tiles"]
    return dict(counts=bins[:t], offsets=bins[t:2 * t + 1],
                chunk_offsets=bins[2 * t + 1:3 * t + 2],
                chunk_tiles=bins[3 * t + 2:])


def block_plan(cfg) -> dict:
    """The accumulation's block for `cfg` on the current card: threads,
    shared memory, registers and spilled bytes a thread, resident blocks
    an SM, and the particles of its chunk and of a batch."""
    batch, taps = batch_size(cfg), profile_taps(cfg)
    out = (ctypes.c_int * 5)()
    LIBRARY.call("splat_plan", batch, taps, cfg.tile + 2 * cfg.apron,
                 cfg.channels, out)
    return dict(zip(("threads", "smem_bytes", "registers", "spill_bytes",
                     "blocks_per_sm"), out), chunk=chunk_size(cfg),
                batch=batch,
                taps=taps, direct=DIRECT, lanes=LANES[cfg.kernel])


def bin_plan(cfg, x, y, live, chunk=None) -> dict:
    """The plain version of K5's bins: each slot's tile (`tile`, int64,
    -1 for a dead or off-screen slot, the on-screen test and the
    truncated tile of `tiled._splat_selection` and `_footprints`), each
    tile's count, the exclusive `offsets` of the counts and
    `chunk_offsets` of the chunks (ceil(count / chunk) a tile), both with
    the total last, and the chunk table `chunks` (M, 3): tile, first and
    end entry of the tile-ordered list. `chunk` None: `chunk_size`.
    Pure: no host read."""
    chunk = chunk_size(cfg) if chunk is None else chunk
    gy, gx = cfg.grid
    a, t = cfg.apron, cfg.tile
    ok = live & ((x > -(a + 1.0)) & (x < cfg.width + a + 1.0)
                 & (y > -(a + 1.0)) & (y < cfg.height + a + 1.0))

    def axis(p, g):
        return torch.clamp((p / t).to(torch.int64), 0, g - 1)

    tile = torch.where(ok, axis(y, gy) * gx + axis(x, gx), -1)
    counts = torch.bincount(tile[ok], minlength=gy * gx)
    zero = counts.new_zeros(1)
    offsets = torch.cat([zero, torch.cumsum(counts, 0)])
    per_tile = torch.div(counts + chunk - 1, chunk, rounding_mode="floor")
    chunk_offsets = torch.cat([zero, torch.cumsum(per_tile, 0)])
    chunk_tile = torch.repeat_interleave(
        torch.arange(gy * gx, device=x.device), per_tile)
    j = torch.arange(chunk_tile.shape[0], device=x.device) \
        - chunk_offsets[chunk_tile]
    first = offsets[chunk_tile] + j * chunk
    end = torch.minimum(first + chunk, offsets[chunk_tile + 1])
    return dict(tile=tile, counts=counts, offsets=offsets,
                chunk_offsets=chunk_offsets,
                chunks=torch.stack([chunk_tile, first, end], dim=1))


def splat_binned_reference(cfg, x, y, color, size, live, chunk=None):
    """K5's accumulation in PyTorch: the particles in tile order (index
    order in each tile), each chunk of `bin_plan`'s table splatted into
    its tile's window, the window then added to the image. Equal to
    `rasterize_tiled_reference` up to the order of each pixel's sum (the
    kernel adds a tile of at most DIRECT particles to the image directly:
    the same sums in another order). -> (H, W, C) float32."""
    H, W, ch = cfg.height, cfg.width, cfg.channels
    T, A = cfg.tile, cfg.apron
    plan = bin_plan(cfg, x, y, live, chunk)
    tile = plan["tile"]
    order = torch.argsort(torch.where(tile >= 0, tile,
                                      plan["counts"].shape[0]), stable=True)
    img = torch.zeros((H * W, ch), dtype=torch.float32, device=x.device)
    gx = cfg.grid[1]
    side = T + 2 * A
    for tile, first, end in plan["chunks"].tolist():
        sel = order[first:end]
        ty, tx = divmod(tile, gx)
        ylo, xlo = max(ty * T - A, 0), max(tx * T - A, 0)
        yhi, xhi = min(ty * T + T + A, H), min(tx * T + T + A, W)
        radius = torch.clamp(size[sel] * 0.5, 0.5, A + 0.5)
        (px, wx), (py, wy) = tiled._footprints(cfg, x[sel], y[sel], radius)
        window = torch.zeros((side * side, ch), dtype=torch.float32,
                             device=x.device)
        rgb = color[sel, :ch]
        for j in range(wy.shape[1]):
            w = wy[:, j:j + 1] * wx
            idx = (py[:, j:j + 1] - ylo) * side + (px - xlo)
            # Taps outside the window have weight 0 (`_footprints`).
            idx = torch.clamp(idx, 0, side * side - 1)
            window.index_add_(0, idx.reshape(-1),
                              (w[..., None] * rgb[:, None, :]).reshape(-1,
                                                                       ch))
        window = window.reshape(side, side, ch)[:yhi - ylo, :xhi - xlo]
        img.view(H, W, ch)[ylo:yhi, xlo:xhi] += window
    return img.reshape(H, W, ch)
