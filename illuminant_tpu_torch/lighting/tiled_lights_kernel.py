"""Tiled particle-light shading: the CUDA source `csrc/tiled_lights.cu`
(K10), its wrapper and its plain PyTorch version.

Replaces the XLA shading stage of `illuminant_tpu/lighting/tiled_lights.py:
accumulate_sphere_lights_tiled` (:229-291), which has no Pallas kernel:
there every chunk of 8 binned lights becomes (T, 8, tile, tile) opacity
planes contracted with the lights' colours by a bfloat16 einsum over a
padded, tiled frame. K10 computes, for each screen tile, pix_f x the sum
over the tile's binned slots k of col4_k x opacity_k (computeSphereLight
Opacity, LightCommon.fxh:173-210), in float32, slots in order, straight
into the (H, W, 4) image ((H, W, 3) without alpha).

On a CPU tensor `tiled_light_accumulate` runs the plain version
(`tiled_light_accumulate_reference`, one slot at a time in slot order); a
CUDA tensor launches the kernel or raises. The library is compiled from
the repository's source at first use (`core/cuda_build`).
"""

from __future__ import annotations

import ctypes

import torch

from ..core import cuda_build

_SOURCE = cuda_build.CSRC / "tiled_lights.cu"
_LIBRARY = cuda_build.library_path(_SOURCE)
RECORD = 8
# The kernel's limits: a tile's pixels are a loop of its block, its slots
# are staged in shared memory (128 KB at 4096).
MAX_CAPACITY = 4096
MAX_TILE = 1024

# Launches since import (or since a caller reset it): the wrapper adds one
# where it launches the kernel and nowhere else.
LAUNCHES = 0

_lib = None


def build():
    """Compile csrc/tiled_lights.cu unless an up-to-date library is there."""
    return cuda_build.build(_SOURCE, _LIBRARY)


def _library():
    global _lib
    if _lib is None:
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        _lib = cuda_build.load(_SOURCE, _LIBRARY, {
            "tiled_lights": [ptr] * 9 + [i32] * 4 + [f32] * 3 + [
                i32, f32, i32, ptr],
            "tiled_lights_plan": [i32, i32, ctypes.POINTER(ctypes.c_int)]})
    return _lib


def launch_plan(tile: int, capacity: int) -> dict:
    """The block a K10 launch takes at these sizes on the current card:
    threads, dynamic shared memory bytes, resident blocks an SM,
    registers and spilled bytes a thread."""
    _check_sizes(tile, capacity)
    out = (ctypes.c_int * 5)()
    cuda_build.check(_library().tiled_lights_plan(tile, capacity, out),
                     "tiled_lights_plan")
    return dict(zip(("threads", "smem_bytes", "blocks_per_sm", "registers",
                     "spill_bytes"), out))


def _check_sizes(tile: int, capacity: int):
    if not (1 <= tile <= MAX_TILE and 1 <= capacity <= MAX_CAPACITY):
        raise ValueError(f"tiled_light_accumulate: the kernel takes a tile "
                         f"of 1 to {MAX_TILE} pixels and 1 to "
                         f"{MAX_CAPACITY} slots a tile; got tile {tile}, "
                         f"capacity {capacity}")


def _check(z, relative_y, normal, pix_f, idx, mask, records, tile):
    h, w = z.shape
    th, tw = -(-h // tile), -(-w // tile)
    planes = (("z", z, (h, w)), ("relative_y", relative_y, (h, w)),
              ("normal", normal, (h, w, 3)), ("pix_f", pix_f, (h, w)))
    for name, t, shape in planes:
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"tiled_light_accumulate: {name} must be "
                             f"float32 {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if (idx.dim() != 2 or idx.shape[0] != th * tw
            or idx.dtype != torch.int32 or mask.shape != idx.shape
            or mask.dtype != torch.bool):
        raise ValueError(f"tiled_light_accumulate: idx must be int32 and "
                         f"mask bool, both ({th * tw}, K); got "
                         f"{idx.dtype} {tuple(idx.shape)}, {mask.dtype} "
                         f"{tuple(mask.shape)}")
    if (records.dim() != 2 or records.shape[1] != RECORD
            or records.dtype != torch.float32):
        raise ValueError(f"tiled_light_accumulate: records must be float32 "
                         f"(N, {RECORD}), got {records.dtype} "
                         f"{tuple(records.shape)}")


def occluded(df, d3z, lo, occl_on):
    """df scaled by the light-occlusion term where `occl_on` (the
    environment's light_occlusion > 0; the kernel skips the term when it
    is not), `lo` the occlusion clamped to at least 1e-6."""
    return df * torch.where(occl_on, 1.0 - torch.clamp(d3z / lo, 0.0, 1.0),
                            1.0)


def tiled_light_accumulate_reference(z, relative_y, normal, pix_f, idx,
                                     mask, records, light_occlusion,
                                     tile: int, radius: float,
                                     ramp_length: float, y_factor: float,
                                     ramp_mode: int, render_scale: float,
                                     with_alpha: bool = True):
    """Plain version of K10, the kernel's operation order: for each slot
    k in order, every pixel of tile t shades light idx[t, k] (the JAX
    package's chunk_contrib, tiled_lights.py:229-271, in float32) and
    adds opacity x (r, g, b, 1) of its record to its sum; the sum is then
    scaled by pix_f. records (N, 8): x, y, z, on, weighted r, g, b, 1;
    `ramp_length` and `y_factor` already clamped as the JAX package
    clamps them; `light_occlusion` a 0-d tensor."""
    h, w = z.shape
    dev = z.device
    f32 = torch.float32
    tw = -(-w // tile)
    ys = (torch.arange(h, dtype=f32, device=dev) + 0.5) / render_scale
    xs = (torch.arange(w, dtype=f32, device=dev) + 0.5) / render_scale
    wx = xs[None, :]
    wy = ys[:, None] + relative_y
    nx, ny, nz = normal.unbind(-1)
    no_normal = (nx == 0.0) & (ny == 0.0) & (nz == 0.0)
    tid = ((torch.arange(h, device=dev) // tile)[:, None] * tw
           + (torch.arange(w, device=dev) // tile)[None, :])
    lo = torch.clamp(light_occlusion, min=1e-6)
    occl_on = light_occlusion > 0.0
    acc = torch.zeros((h, w, 4), dtype=f32, device=dev)
    for k in range(idx.shape[1]):
        rec = records[idx[:, k].long()]
        rec = torch.cat([rec[:, :3], (rec[:, 3] * mask[:, k].to(f32))[:, None],
                         rec[:, 4:]], dim=1)[tid]  # (H, W, 8)
        d3x = wx - rec[..., 0]
        d3y = (wy - rec[..., 1]) * y_factor
        d3z = z - rec[..., 2]
        distance = torch.sqrt(d3x * d3x + d3y * d3y + d3z * d3z + 1e-12)
        df = 1.0 - torch.clamp((distance - radius) / ramp_length, 0.0, 1.0)
        df = occluded(df, d3z, lo, occl_on)
        dot = -(d3x * nx + d3y * ny + d3z * nz) / distance
        nf = torch.clamp((dot + 0.15) / 0.15, 0.0, 1.0) ** 0.85
        nf = torch.where(no_normal, 1.0, nf)
        if ramp_mode >= 2:
            df = 1.0 - torch.clamp(distance - radius, 0.0, 1.0)
            nf = torch.ones_like(nf)
        elif ramp_mode >= 1:
            df = df * df
        op = torch.clamp(nf * df + torch.clamp(radius - distance, 0.0, 1.0),
                         0.0, 1.0) * rec[..., 3]
        acc = acc + op[..., None] * rec[..., 4:]
    out = acc * pix_f[..., None]
    return out if with_alpha else out[..., :3].contiguous()


def tiled_light_accumulate(z, relative_y, normal, pix_f, idx, mask, records,
                           light_occlusion, tile: int, radius: float,
                           ramp_length: float, y_factor: float,
                           ramp_mode: int, render_scale: float,
                           with_alpha: bool = True):
    """Shade each tile's binned lights into the (H, W, 4) image ((H, W, 3)
    without alpha); see `tiled_light_accumulate_reference` for the
    arguments. A CPU tensor runs the plain version; a CUDA tensor launches
    K10 on the current stream, or raises."""
    global LAUNCHES
    _check(z, relative_y, normal, pix_f, idx, mask, records, tile)
    args = (tile, float(radius), float(ramp_length), float(y_factor),
            int(ramp_mode), float(render_scale), with_alpha)
    if z.device.type == "cpu":
        return tiled_light_accumulate_reference(
            z, relative_y, normal, pix_f, idx, mask, records,
            light_occlusion, *args)
    tensors = (z, relative_y, normal, pix_f, idx, mask, records,
               light_occlusion)
    dev = z.device
    if dev.type != "cuda":
        raise ValueError(f"tiled_light_accumulate: no kernel for device "
                         f"{dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError("tiled_light_accumulate: the tensors must "
                             "share a device")
        if not t.is_contiguous():
            raise ValueError("tiled_light_accumulate: the tensors must be "
                             "contiguous")
    if light_occlusion.numel() != 1 or light_occlusion.dtype != torch.float32:
        raise ValueError("tiled_light_accumulate: light_occlusion must be "
                         "one float32 value")
    if records.data_ptr() % 16:
        raise ValueError("tiled_light_accumulate: records must be 16-byte "
                         "aligned")
    h, w = z.shape
    capacity = idx.shape[1]
    _check_sizes(tile, capacity)
    out = torch.empty((h, w, 4 if with_alpha else 3), dtype=torch.float32,
                      device=dev)
    with torch.cuda.device(dev):
        err = _library().tiled_lights(
            z.data_ptr(), relative_y.data_ptr(), normal.data_ptr(),
            pix_f.data_ptr(), idx.data_ptr(), mask.data_ptr(),
            records.data_ptr(), light_occlusion.data_ptr(), out.data_ptr(),
            h, w, tile, capacity, args[1], args[2], args[3], args[4],
            args[5], int(bool(with_alpha)),
            torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(err, "tiled_lights")
    LAUNCHES += 1
    return out
