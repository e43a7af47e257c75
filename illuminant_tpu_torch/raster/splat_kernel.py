"""The additive particle splat on the card: the CUDA source `csrc/splat.cu`
(K5), its wrapper and its launch plan.

K5 replaces the device work of `illuminant_tpu/raster/tiled.py:
rasterize_tiled` (:589) and, in the port, the plain direct splat
`raster/tiled.py:rasterize_tiled_reference`, which is its plain version:
one thread a particle walks its own support (`support_taps`)
inside its tile's window and adds colour x wy x wx with float atomics, so
a call reads nothing back (the plain version's `nonzero` and `amax` are
two host reads) and never drops a particle. The source's header says what
bounds it and what the design does about it.

`splat_cuda` launches the kernel on CUDA tensors or raises; `launch_plan`
is pure and runs on the CPU. The library is compiled from the
repository's source at first use (`core/cuda_build`).
"""

from __future__ import annotations

import ctypes

import torch

from ..core import cuda_build

_SOURCE = cuda_build.CSRC / "splat.cu"
_LIBRARY = cuda_build.library_path(_SOURCE)

# The source's Kind.
KERNELS = {"point": 0, "quad": 1, "gauss": 2, "round": 3}

# Launches since import (or since a caller reset it): the wrapper adds one
# where it launches the kernel and nowhere else.
LAUNCHES = 0

_lib = None


def build():
    """Compile csrc/splat.cu unless an up-to-date library is there."""
    return cuda_build.build(_SOURCE, _LIBRARY)


def _library():
    global _lib
    if _lib is None:
        i64p = ctypes.POINTER(ctypes.c_longlong)
        _lib = cuda_build.load(_SOURCE, _LIBRARY, {
            "splat": [ctypes.POINTER(ctypes.c_void_p), i64p, i64p,
                      ctypes.c_void_p]})
    return _lib


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


def launch_plan(cfg, x, y, color, size, live) -> dict:
    """Everything a K5 launch is given, from `rasterize_tiled`'s arguments
    (cfg a TiledRasterConfig): the particle count, each argument's
    element stride (`strides`: x, y, size, live, colour row, colour
    column) and the source's `ints` (n, height, width, tile, apron,
    grid_y, grid_x, channels, kernel). Pure: no kernel, no host read."""
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
    gy, gx = cfg.grid
    return dict(
        n=n,
        strides=[x.stride(0), y.stride(0), size.stride(0), live.stride(0),
                 color.stride(0), color.stride(1)],
        ints=[n, cfg.height, cfg.width, cfg.tile, cfg.apron, gy, gx,
              cfg.channels, KERNELS[cfg.kernel]])


def splat_cuda(cfg, x, y, color, size, live):
    """One K5 launch on the current stream -> the (H, W, C) float32
    image. CUDA tensors only; views of any stride are read in place."""
    global LAUNCHES
    plan = launch_plan(cfg, x, y, color, size, live)
    dev = x.device
    if dev.type != "cuda" or any(t.device != dev
                                 for t in (y, color, size, live)):
        raise ValueError(f"splat_cuda: no kernel for device {dev} (every "
                         "tensor must lie on one CUDA device)")
    img = torch.zeros((cfg.height, cfg.width, cfg.channels),
                      dtype=torch.float32, device=dev)
    if plan["n"] == 0:
        return img
    ptr_list = [t.data_ptr() for t in (x, y, size, live, color, img)]
    ptrs = (ctypes.c_void_p * 6)(*ptr_list)
    strides = (ctypes.c_longlong * 6)(*plan["strides"])
    ints = (ctypes.c_longlong * 9)(*plan["ints"])
    with torch.cuda.device(dev):
        err = _library().splat(ptrs, strides, ints,
                               torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(err, "splat")
    LAUNCHES += 1
    return img
