"""The scan shadows' column walk on the card: the CUDA source
`csrc/scan_walk.cu` (K1), its wrapper and its launch plan.

K1 replaces the per-column Python loop of `scan_shadows._bidirectional_scan`
(~16 small kernels a column, ~12,000 launches a 1080p flagship frame) and,
through it, the `lax.scan` of `illuminant_tpu/lighting/scan_shadows.py:
_bidirectional_scan` (:150): one launch a `scan_visibility` call walks
every axis, direction and light, one block a (sector, light), and writes
the pre-merge carries of each sector in the readout's layout, (4, C, L,
H, W): east, west, north, south, each contiguous, the reverse walks'
flips and the N/S walk's transpose undone. The source's header says what
bounds it and what the design does about it.

`scan_walk_cuda` launches the kernel or raises; `scan_shadows.scan_walk`
calls it for CUDA tensors and the plain version,
`scan_shadows.scan_walk_reference`, for CPU tensors. `launch_plan` is
pure and runs on the CPU; `block_plan` reports an instance's registers on
the card. The library is compiled from the repository's source at first
use (`core/cuda_build`).
"""

from __future__ import annotations

import ctypes

import torch

from ..core import cuda_build
from .scan_shadows import _BIG, _BOT_FILL, _TOP_FILL

LIBRARY = cuda_build.Library("scan_walk.cu", {
    "scan_walk": [ctypes.c_void_p] * 8 + [ctypes.POINTER(ctypes.c_int),
                                          ctypes.POINTER(ctypes.c_float),
                                          ctypes.c_void_p],
    "scan_walk_plan": [ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(ctypes.c_int)]}, ["k1_scan_walk"])

# The source's limits: a block of at most 1,024 threads, a thread 1, 2 or
# 4 consecutive rows of the walk (the instances), the columns staged 8, 4,
# 2 or 1 at a time, whichever is the most that fits the shared memory a
# block may opt in to (227 KB on an H100).
MAX_THREADS = 1024
ROWS_PER_THREAD = (1, 2, 4)
TILE_COLS = (8, 4, 2, 1)
SMEM_MAX = 232448


def _padded_rows(rows: int) -> int:
    """The source's `padded_rows`: a tile's row stride in shared memory."""
    return -(-rows // 32) * 32 + 4


def launch_plan(height: int, width: int, lights: int,
                footprint: bool = False, extra: bool = False) -> dict:
    """The K1 launch for an (height, width) nomination grid and `lights`
    lights, with or without the footprint and the extras: `blocks` (4 x
    lights), `threads`, `rows_per_thread`, `tile_cols`, `smem_bytes`,
    the kernel `instance`, the output `channels` (d, k, neg_k[, f_min][,
    h_top, h_bot]) and `shape` (4, channels, lights, height, width).
    Pure: no kernel, no tensor. Raises ValueError where the kernel does
    not take the grid."""
    if min(height, width) < 1 or lights < 0:
        raise ValueError(f"scan_walk: no walk of {lights} lights on a "
                         f"{height} x {width} grid")
    rows = max(height, width)
    per = next((r for r in ROWS_PER_THREAD if -(-rows // r) <= MAX_THREADS),
               None)
    if per is None:
        raise ValueError(f"scan_walk: {rows} rows exceed the kernel's "
                         f"{MAX_THREADS * ROWS_PER_THREAD[-1]}")
    owners = -(-rows // per)  # threads that own a row
    threads = -(-owners // 32) * 32
    carries = 4 if footprint else 3
    channels = carries + (2 if extra else 0)
    images = 1 + int(footprint) + (2 if extra else 0)
    state = carries + (3 if extra else 0)
    edges = 2 * (threads // 32) * 2 * state * 4

    def smem(cols):
        east_west = (2 * images + 2 * channels) * cols \
            * _padded_rows(height) * 4
        north_south = 2 * images * cols * _padded_rows(width) * 4
        return max(east_west, north_south) + edges

    tile = next((c for c in TILE_COLS if smem(c) <= SMEM_MAX), None)
    if tile is None:
        raise ValueError(f"scan_walk: a {height} x {width} grid needs "
                         f"{smem(1)} B of shared memory, above {SMEM_MAX}")
    instance = ROWS_PER_THREAD.index(per) * 4 + 2 * int(footprint) \
        + int(extra)
    return dict(blocks=4 * lights, threads=threads, rows_per_thread=per,
                tile_cols=tile, smem_bytes=smem(tile), instance=instance,
                channels=channels,
                shape=(4, channels, lights, height, width))


def scan_walk_cuda(occ, light_x, light_y, light_radius, exit_band: float,
                   extra=(), footprint=None):
    """One K1 launch on the current stream: the column walks of every
    sector of `occ` (H, W) for the lights at grid pixels light_x /
    light_y with near-skip radius light_radius (L,), the arguments as
    `scan_shadows.scan_walk`'s -> (4, C, L, H, W) float32, east, west,
    north, south. CUDA tensors only."""
    h, w = occ.shape
    n_lights = light_x.shape[0]
    plan = launch_plan(h, w, n_lights, footprint is not None, bool(extra))
    dev = occ.device
    images = [occ] + ([] if footprint is None else [footprint]) + list(extra)
    lights = [light_x, light_y, light_radius]
    tensors = images + lights
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"scan_walk_cuda: no kernel for device {dev} (every "
                         "tensor must lie on one CUDA device)")
    if any(tuple(t.shape) != (h, w) for t in images) or \
            any(tuple(t.shape) != (n_lights,) for t in lights):
        raise ValueError("scan_walk_cuda: the images must be (H, W) and the "
                         "lights (L,)")
    images = [t.to(torch.float32).contiguous() for t in images]
    lights = [t.to(torch.float32).contiguous() for t in lights]
    if 4 * plan["channels"] * n_lights * h * w >= 2 ** 31:
        raise ValueError("scan_walk_cuda: the output reaches 2^31 elements")
    out = torch.empty(plan["shape"], dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    occ_c = images[0]
    foot_c = images[1] if footprint is not None else None
    top_c, bot_c = images[-2:] if extra else (None, None)
    ints = (ctypes.c_int * 7)(h, w, n_lights, plan["instance"],
                              plan["threads"], plan["tile_cols"],
                              plan["smem_bytes"])
    floats = (ctypes.c_float * 4)(exit_band, _BIG, _TOP_FILL, _BOT_FILL)

    def ptr(t):
        return None if t is None else t.data_ptr()

    LIBRARY.launch("k1_scan_walk", "scan_walk", dev, ptr(occ_c),
                   ptr(foot_c), ptr(top_c), ptr(bot_c),
                   *(t.data_ptr() for t in lights), out.data_ptr(), ints,
                   floats)
    return out


def block_plan(height: int, width: int, lights: int, footprint: bool = False,
               extra: bool = False) -> dict:
    """`launch_plan` and, on the current card, the instance's registers and
    spilled bytes a thread and the most threads a block may take."""
    plan = launch_plan(height, width, lights, footprint, extra)
    out = (ctypes.c_int * 3)()
    LIBRARY.call("scan_walk_plan", plan["instance"], plan["smem_bytes"], out)
    return dict(plan, registers=out[0], spill_bytes=out[1],
                max_threads=out[2])
