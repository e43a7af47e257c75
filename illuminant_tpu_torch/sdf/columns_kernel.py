"""Column-map sampler: the CUDA kernel `csrc/column_maps.cu` and its plain
PyTorch version.

Replaces the Pallas TPU kernel `illuminant_tpu/sdf/columns_pallas.py:
sample_maps`: a bilinear sample of the (C, Hc, Wc) column-map pack at N
texel coordinates, plus map 0's two texel-space derivatives with
`want_grad`, as a (C[+2], N) float32 array.

What bounds it on an H100: per point, four scattered reads of each of the
C maps (at C = 5 with the gradient about 28 bytes of useful map data that
arrive as L2 sector reads) and 28 bytes of output writes, against ~40
flops — a memory-latency-bound gather. The design answers with the plain
shape: one thread per point, maps kept in float32 (648 KB at the 1080p
flagship, resident in the 50 MB L2) and read with `__ldg`, the point loop
point-major so that the (C[+2], N) output rows are written with coalesced
stores. The TPU kernel cast the maps to bf16 for the MXU; this one keeps
float32, so it is closer to the exact bilinear than the reference.

`sample_maps` chooses by device: a CPU tensor takes `sample_maps_reference`;
a CUDA tensor launches the kernel or raises. The kernel is compiled from
the repository's source with nvcc at first use, into
`build/illuminant_tpu_torch/` beside the package.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "column_maps.cu"
_BUILD_DIR = (Path(__file__).resolve().parents[2] / "build"
              / "illuminant_tpu_torch")
_LIBRARY = _BUILD_DIR / "libcolumn_maps.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Launches of the CUDA kernel since import (or since a caller reset it):
# `sample_maps` adds one where it launches the kernel and nowhere else.
LAUNCHES = 0
# nvcc's output from the build of this process (ptxas register and
# shared-memory report), or None before the first build.
BUILD_LOG = None

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found: the column-map kernel needs the "
                       "CUDA toolkit to build")


def build() -> Path:
    """Compile csrc/column_maps.cu into the build directory unless an
    up-to-date library is already there. The library is written under a
    temporary name and renamed into place, so concurrent builds never
    load a half-written file."""
    global BUILD_LOG
    if (_LIBRARY.exists()
            and _LIBRARY.stat().st_mtime >= _SOURCE.stat().st_mtime):
        return _LIBRARY
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(_SOURCE)],
            capture_output=True, text=True)
        BUILD_LOG = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {_SOURCE}:\n{BUILD_LOG}")
        os.replace(tmp, _LIBRARY)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return _LIBRARY


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.column_maps_sample
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _taps(t, n: int):
    """i0 = clip(floor(t), 0, n-1), i1 = min(i0+1, n-1), w = t - floor(t)
    from the unclipped floor (columns_pallas._rows)."""
    fl = torch.floor(t)
    i0 = torch.clamp(fl, 0, n - 1).long()
    i1 = torch.clamp(i0 + 1, max=n - 1)
    return i0, i1, t - fl


def sample_maps_reference(maps, ty, tx, want_grad: bool = False):
    """Plain PyTorch version of the kernel, float32, same edge rules:
    maps (C, Hc, Wc), ty/tx (N,) texel coords -> (C[+2], N)."""
    n_maps, hc, wc = maps.shape
    y0, y1, wy = _taps(ty, hc)
    x0, x1, wx = _taps(tx, wc)
    flat = maps.reshape(n_maps, hc * wc)
    v00 = flat[:, y0 * wc + x0]
    v01 = flat[:, y0 * wc + x1]
    v10 = flat[:, y1 * wc + x0]
    v11 = flat[:, y1 * wc + x1]
    col0 = (1.0 - wy) * v00 + wy * v10
    col1 = (1.0 - wy) * v01 + wy * v11
    out = (1.0 - wx) * col0 + wx * col1
    if not want_grad:
        return out
    row0 = (1.0 - wx) * v00[0] + wx * v01[0]
    row1 = (1.0 - wx) * v10[0] + wx * v11[0]
    return torch.cat([out, (col1[0] - col0[0])[None],
                      (row1 - row0)[None]], dim=0)


def _check(maps, ty, tx):
    if maps.dim() != 3 or ty.dim() != 1 or tx.shape != ty.shape:
        raise ValueError(
            f"sample_maps wants maps (C, Hc, Wc) and ty, tx (N,); got "
            f"{tuple(maps.shape)}, {tuple(ty.shape)}, {tuple(tx.shape)}")
    for name, t in (("maps", maps), ("ty", ty), ("tx", tx)):
        if t.dtype != torch.float32:
            raise TypeError(f"sample_maps: {name} must be float32, got "
                            f"{t.dtype}")
    if not (maps.device == ty.device == tx.device):
        raise ValueError("sample_maps: maps, ty and tx must share a device")


def sample_maps(maps, ty, tx, want_grad: bool = False):
    """Bilinear-sample the (C, Hc, Wc) map pack at texel coords (ty, tx)
    (N,) -> (C[+2], N) float32; rows C and C+1 are map 0's texel-space
    derivatives d/dtx and d/dty when `want_grad`.

    A CPU tensor runs the plain version; a CUDA tensor launches the
    kernel on the current stream, or raises."""
    global LAUNCHES
    _check(maps, ty, tx)
    if maps.device.type == "cpu":
        return sample_maps_reference(maps, ty, tx, want_grad)
    if maps.device.type != "cuda":
        raise ValueError(f"sample_maps: no kernel for device {maps.device}")
    for name, t in (("maps", maps), ("ty", ty), ("tx", tx)):
        if not t.is_contiguous():
            raise ValueError(f"sample_maps: {name} must be contiguous")
    n_maps, hc, wc = maps.shape
    n = ty.shape[0]
    out = torch.empty((n_maps + (2 if want_grad else 0), n),
                      dtype=torch.float32, device=maps.device)
    if n == 0:
        return out
    lib = _library()
    with torch.cuda.device(maps.device):
        stream = torch.cuda.current_stream(maps.device).cuda_stream
        err = lib.column_maps_sample(
            maps.data_ptr(), ty.data_ptr(), tx.data_ptr(), out.data_ptr(),
            n_maps, hc, wc, n, int(bool(want_grad)), stream)
    if err != 0:
        raise RuntimeError(f"column_maps_sample launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    return out
