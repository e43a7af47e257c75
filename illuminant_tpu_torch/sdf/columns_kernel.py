"""Column-map kernels: the CUDA source `csrc/column_maps.cu`, its wrappers
and their plain PyTorch versions.

Replaces the Pallas TPU kernel `illuminant_tpu/sdf/columns_pallas.py:
sample_maps` (a bilinear sample of the (C, Hc, Wc) column-map pack at N
texel coordinates, plus map 0's two texel-space derivatives with
`want_grad`) and, through the fused query, the elementwise head and tail
that wrap it in a ColumnField query. Three kernels, one wrapper each:
  * `pack_maps`: the planar (C, Hc, Wc) maps -> one "quad" record per
    texel, (Hc, Wc, R) float32 with R = 4C rounded up to 4: the four taps
    of the cell whose low corner the texel is, the edge clamp baked in;
  * `sample_maps`: the direct counterpart of the Pallas kernel, (C[+2], N)
    out; it packs, then samples with the device function the query uses;
  * `query_columns`: the fused ColumnField query from world positions to
    the distance, or the distance and the (optionally unit) gradient,
    behind `sdf/columns.py:query`.

What bounds them on an H100 is bytes; the source's header says what the
design does about it. On a CPU tensor `pack_maps` and `sample_maps` run
their plain versions (`pack_maps_reference`, `sample_maps_reference`); a
CUDA tensor launches the kernel or raises. The library is compiled from
the repository's source at first use (`core/cuda_build`).
"""

from __future__ import annotations

import ctypes

import torch

from ..core import cuda_build

MAX_MAPS = 8
# The fused query's ColumnField constants, in the order of the source's
# `Geometry` (`columns.query_geometry` computes them).
QUERY_GEOMETRY = ("ex", "ey", "ez", "z_offset", "scale_x", "scale_y", "rx",
                  "ry", "sx_c", "sy_c", "z_lo", "z_hi")

_ptr, _i32, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
LIBRARY = cuda_build.Library("column_maps.cu", {
    "column_maps_pack": [_ptr, _ptr, _i32, _i32, _i32, _ptr],
    "column_maps_sample": [_ptr, _ptr, _ptr, _ptr, _i32, _i32, _i32, _i64,
                           _i32, _ptr],
    "column_query": [_ptr, _i32, _i32, ctypes.POINTER(ctypes.c_float), _ptr,
                     _i64, _ptr, _i64, _ptr, _i64, _i64, _i32, _i32, _ptr,
                     _ptr, _ptr, _ptr, _ptr]},
    ["k7_column_pack", "k7_column_sample", "k7_column_query"])


def _on_cuda(name: str, tensors):
    """Raise unless every tensor lies on one CUDA device."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: the tensors must share a device")


def _record(n_maps: int) -> int:
    """Floats per texel record of the pack: four taps of n_maps, rounded
    up to whole 16-byte vectors."""
    return -(-4 * n_maps // 4) * 4


def _taps(t, n: int):
    """i0 = clip(floor(t), 0, n-1), i1 = min(i0+1, n-1), w = t - floor(t)
    from the unclipped floor (columns_pallas._rows)."""
    fl = torch.floor(t)
    i0 = torch.clamp(fl, 0, n - 1).long()
    i1 = torch.clamp(i0 + 1, max=n - 1)
    return i0, i1, t - fl


def pack_maps_reference(maps):
    """Plain PyTorch version of the pack kernel: (C, Hc, Wc) -> (Hc, Wc,
    R) float32, unused slots zero. The record of texel (y, x) holds the
    taps (y, x), (y, x1), (y1, x), (y1, x1), each C maps long, with
    y1 = min(y + 1, Hc - 1) and x1 = min(x + 1, Wc - 1)."""
    n_maps, hc, wc = maps.shape
    dev = maps.device
    m = maps.permute(1, 2, 0)
    y1 = torch.clamp(torch.arange(hc, device=dev) + 1, max=hc - 1)
    x1 = torch.clamp(torch.arange(wc, device=dev) + 1, max=wc - 1)
    m = torch.cat([m, m[:, x1], m[y1], m[y1][:, x1]], dim=-1)
    pack = torch.zeros((hc, wc, _record(n_maps)), dtype=torch.float32,
                       device=dev)
    pack[..., :m.shape[-1]] = m
    return pack


def _check_maps(name: str, maps):
    if maps.dim() != 3:
        raise ValueError(f"{name} wants maps (C, Hc, Wc); got "
                         f"{tuple(maps.shape)}")
    if maps.dtype != torch.float32:
        raise TypeError(f"{name}: maps must be float32, got {maps.dtype}")


def pack_maps(maps):
    """Pack the (C, Hc, Wc) maps into (Hc, Wc, R) texel records (see
    `pack_maps_reference`). A CPU tensor runs the plain version; a CUDA
    tensor launches the pack kernel on the current stream, or raises."""
    _check_maps("pack_maps", maps)
    n_maps, hc, wc = maps.shape
    if not 1 <= n_maps <= MAX_MAPS:
        raise ValueError(f"pack_maps: the pack takes 1 to {MAX_MAPS} "
                         f"maps, got {n_maps}")
    if maps.device.type == "cpu":
        return pack_maps_reference(maps)
    _on_cuda("pack_maps", [maps])
    if not maps.is_contiguous():
        raise ValueError("pack_maps: maps must be contiguous")
    pack = torch.empty((hc, wc, _record(n_maps)), dtype=torch.float32,
                       device=maps.device)
    LIBRARY.launch("k7_column_pack", "column_maps_pack", maps.device,
                   maps.data_ptr(), pack.data_ptr(), n_maps, hc, wc)
    return pack


def packed(field):
    """The quad pack of a ColumnField's maps (`pack_maps(field.maps_c)`),
    built at the first call on the field and kept on it; built again once
    its maps change (another tensor, or the same one written in place).
    The kernels that sample a field's maps across calls take it here: one
    pack a new set of maps. An inference tensor, which keeps no version,
    is packed every call."""
    maps = field.maps_c
    if maps.is_inference():
        return pack_maps(maps.to(torch.float32).contiguous())
    kept = getattr(field, "_quad_pack", None)
    if kept is not None and kept[0] is maps and kept[1] == maps._version:
        return kept[2]
    pack = pack_maps(maps.to(torch.float32).contiguous())
    object.__setattr__(field, "_quad_pack", (maps, maps._version, pack))
    return pack


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

    A CPU tensor runs the plain version; a CUDA tensor packs the maps
    (`pack_maps`, C <= 8) and launches the sampler on the current stream,
    or raises."""
    _check(maps, ty, tx)
    if maps.device.type == "cpu":
        return sample_maps_reference(maps, ty, tx, want_grad)
    _on_cuda("sample_maps", [maps, ty, tx])
    for name, t in (("ty", ty), ("tx", tx)):
        if not t.is_contiguous():
            raise ValueError(f"sample_maps: {name} must be contiguous")
    n_maps, hc, wc = maps.shape
    n = ty.shape[0]
    out = torch.empty((n_maps + (2 if want_grad else 0), n),
                      dtype=torch.float32, device=maps.device)
    if n == 0:
        return out
    pack = pack_maps(maps)
    LIBRARY.launch("k7_column_sample", "column_maps_sample", maps.device,
                   pack.data_ptr(), ty.data_ptr(), tx.data_ptr(),
                   out.data_ptr(), n_maps, hc, wc, n, int(bool(want_grad)))
    return out


def _flat_arg(name: str, t, n: int):
    """A 1-D float32 CUDA view of n elements -> (pointer, element stride)
    for the kernel; any stride, 0 included (a broadcast scalar)."""
    if t.dim() != 1 or t.shape[0] != n or t.dtype != torch.float32:
        raise ValueError(f"query_columns: {name} must be a float32 (N,) "
                         f"tensor, got {t.dtype} {tuple(t.shape)}")
    return t.data_ptr(), t.stride(0)


def query_columns(pack, geometry, x, y, z, want_grad: bool = False,
                  normalize: bool = False):
    """Launch the fused ColumnField query on the current stream: a
    5-map `pack_maps` pack, the 12 `QUERY_GEOMETRY` floats, world
    positions as three (N,) float32 views of any element stride -> d, or
    (d, gx, gy, gz) with `want_grad` ((gx, gy, gz) of unit length, or 0
    where it vanishes, with `normalize`). CUDA tensors only: the plain
    version is `columns.query_reference`, which `columns.query` takes for
    CPU tensors."""
    _on_cuda("query_columns", [pack, x, y, z])
    hc, wc, rec = pack.shape
    if (pack.dtype != torch.float32 or not pack.is_contiguous()
            or rec != _record(5)):
        raise ValueError(f"query_columns: pack must be a contiguous "
                         f"float32 5-map pack, got {pack.dtype} "
                         f"{tuple(pack.shape)}")
    if len(geometry) != len(QUERY_GEOMETRY):
        raise ValueError(f"query_columns: geometry holds "
                         f"{len(QUERY_GEOMETRY)} values {QUERY_GEOMETRY}")
    n = x.shape[0] if x.dim() == 1 else -1
    args = [_flat_arg(name, t, n) for name, t in (("x", x), ("y", y),
                                                  ("z", z))]
    outs = [torch.empty(n, dtype=torch.float32, device=x.device)
            for _ in range(4 if want_grad else 1)]
    if n == 0:
        return tuple(outs) if want_grad else outs[0]
    ptrs = [o.data_ptr() for o in outs] + [None] * (4 - len(outs))
    geom = (ctypes.c_float * len(QUERY_GEOMETRY))(*map(float, geometry))
    LIBRARY.launch("k7_column_query", "column_query", x.device,
                   pack.data_ptr(), hc, wc, geom, *args[0], *args[1],
                   *args[2], n, int(bool(want_grad)), int(bool(normalize)),
                   *ptrs)
    return tuple(outs) if want_grad else outs[0]
