"""The scan shadows' readout on the card: the CUDA source
`csrc/scan_readout.cu` (K2), its wrapper and its launch plan.

K2 replaces the eager readout after K1's column walk,
`scan_shadows.scan_readout_reference` (~200 full-size passes over the
(L, H, W) readout grid), and through it the XLA stages of
`illuminant_tpu/lighting/scan_shadows.py:scan_visibility`'s readout: one
launch a `scan_visibility` call reads the sector each texel selects from
K1's (4, C, L, nh, nw) output, upsamples the nominated fields in shared
memory, samples the field at the refine's candidates and writes the
visibility. The source's header says what bounds it and what the design
does about it.

The field is packed as K12 packs it (`cone_trace_kernel.field_scalars`,
`instance_for`, `packed_volume`, `columns_kernel.packed`); the readout
adds two instances of its own: the carried column reconstruction, and no
field (the flatland mode, or no scene). `scan_readout_cuda` launches the
kernel or raises; `scan_shadows.scan_readout` calls it for CUDA tensors
and the plain version for CPU tensors. `launch_plan` is pure and runs on
the CPU; `block_plan` reports an instance's block on the card. The
library is compiled from the repository's source at first use
(`core/cuda_build`).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core import cuda_build
from ..core.config import QualitySettings
from ..sdf import columns_kernel
from ..sdf.columns import ColumnField
from ..sdf.volume import SdfVolume
from . import cone_trace_kernel as k12
from .cone_trace import (FULLY_SHADOWED_THRESHOLD, HACK_DISTANCE_OFFSET,
                         MIN_CONE_RADIUS, UNSHADOWED_THRESHOLD)
from .scan_shadows import _BOT_FILL, _TOP_FILL

LIBRARY = cuda_build.Library("scan_readout.cu", {
    "scan_readout": [ctypes.POINTER(ctypes.c_void_p),
                     ctypes.POINTER(ctypes.c_longlong),
                     ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                     ctypes.c_void_p],
    "scan_readout_plan": [ctypes.c_int, ctypes.c_int,
                          ctypes.POINTER(ctypes.c_int)]},
    ["k2_scan_readout"])

# The source's tile (a block's readout pixels, a thread each), its staged
# level's rows and columns (halo included) and its most halvings.
TILE_Y, TILE_X = 8, 32
THREADS = TILE_Y * TILE_X
REGION = (TILE_Y // 2 + 4, TILE_X // 2 + 4)
MAX_HALVINGS = 8
# The field instances: K12's, and the readout's own (the source's
# Instance enum).
INSTANCES = dict(k12.INSTANCES, carried=4, none=5)
# Staged channels a texel: the fractions' complements, the distance, the
# mask; carried, the footprint minimum and the interval's ends.
CHANNELS = {False: 4, True: 7}


def _staged_span(size: int, tile: int, halvings: int, coarse: int) -> list:
    """The most texels of one axis a staged level holds over every tile of
    that axis, levels 0 .. halvings - 1, as the source computes them: from
    the tile's pixels at the readout level down, each level the texels
    under the one above and an edge-clamped neighbour each side."""
    most = [0] * halvings
    for start in range(0, size, tile):
        lo, hi = start, min(start + tile, size) - 1
        for k in range(halvings - 1, -1, -1):
            n = coarse << k
            lo, hi = max((lo >> 1) - 1, 0), min((hi >> 1) + 1, n - 1)
            most[k] = max(most[k], hi - lo + 1)
    return most


def pow_mode(power: float) -> int:
    """The source's `scalar_pow` case of torch.pow(tensor, power) on the
    card: 0 and 1 (a fill, a copy), 0.5, 2, 3, -1, -2, -0.5 (its special
    cases), else 8 (powf)."""
    modes = {0.0: 0, 1.0: 1, 0.5: 2, 2.0: 3, 3.0: 4, -1.0: 5, -2.0: 6,
             -0.5: 7}
    return modes.get(float(power), 8)


def launch_plan(height: int, width: int, lights: int, halvings: int,
                instance: str, scene_floats: int = 0) -> dict:
    """The K2 launch for an (height, width) readout grid of `lights` lanes
    nominated `halvings` halvings below it, on field instance `instance`
    (a name of INSTANCES; an AnalyticScene staged in shared memory brings
    `scene_floats` floats): the `grid` (tile columns, tile rows, lights),
    `threads`, the `levels` (each staged level's most rows and columns),
    `smem_bytes` and the source's `instance` number. Pure: no kernel, no
    tensor. Raises ValueError where the kernel does not take the grid."""
    if min(height, width) < 1 or lights < 1:
        raise ValueError(f"scan_readout: no readout of {lights} lanes on a "
                         f"{height} x {width} grid")
    if not 0 <= halvings <= MAX_HALVINGS or height % (1 << halvings) or \
            width % (1 << halvings):
        raise ValueError(f"scan_readout: {halvings} halvings of a {height} x "
                         f"{width} grid (at most {MAX_HALVINGS}, exact)")
    if instance not in INSTANCES:
        raise ValueError(f"scan_readout: no instance {instance!r}")
    if lights * height * width >= 2 ** 31:
        raise ValueError("scan_readout: the output reaches 2^31 elements")
    nh, nw = height >> halvings, width >> halvings
    levels = list(zip(_staged_span(height, TILE_Y, halvings, nh),
                      _staged_span(width, TILE_X, halvings, nw)))
    if any(r > REGION[0] or c > REGION[1] for r, c in levels):
        raise ValueError(f"scan_readout: a staged level {levels} exceeds "
                         f"the source's {REGION}")
    smem = 0
    if instance == "analytic":
        smem = 4 * (-(-scene_floats // 4) * 4)
    if halvings:
        smem += 4 * 2 * CHANNELS[instance == "carried"] * REGION[0] \
            * REGION[1]
    return dict(grid=(-(-width // TILE_X), -(-height // TILE_Y), lights),
                threads=THREADS, levels=levels, smem_bytes=smem,
                instance=2 * INSTANCES[instance] + int(halvings > 0))


def _field(scene, quality: QualitySettings, use_cols: bool):
    """The field a launch samples -> (instance name, kind (-1: none), its
    ints, floats and tensors in the source's order), as K12 packs it."""
    if quality.scan_refine_samples <= 0 or (scene is None and not use_cols):
        return "none", -1, [], [], []
    if use_cols:
        return "carried", -1, [], [], []
    kind, f_ints, f_floats, f_tensors = k12.field_scalars(scene)
    name = next(k for k, v in k12.INSTANCES.items()
                if v == k12.instance_for(kind, f_ints))
    if isinstance(scene, ColumnField):
        f_tensors = [columns_kernel.packed(scene)]
    elif isinstance(scene, SdfVolume):
        f_tensors = [k12.packed_volume(scene), f_tensors[1]]
    return name, kind, [int(v) for v in f_ints], \
        [float(v) for v in f_floats], f_tensors


def _lane(name, t, lights, dev, components=None):
    """Check a lane array: float32 on `dev`, (L,) or (L, components)."""
    shape = (lights,) if components is None else (lights, components)
    if not torch.is_tensor(t) or t.device != dev or \
            t.dtype != torch.float32 or tuple(t.shape) != shape:
        raise ValueError(f"scan_readout_cuda: {name} must be a float32 "
                         f"{shape} tensor on {dev}")
    return t


def _image(name, t, lights, height, width, dev, components=()):
    """Check a per-pixel array: None, or float32, contiguous, on `dev`,
    (H, W, *components) or (L, H, W, *components) -> (tensor or None,
    per lane)."""
    if t is None:
        return None, False
    shared = (height, width) + components
    if not torch.is_tensor(t) or t.device != dev or \
            t.dtype != torch.float32 or not t.is_contiguous() or \
            tuple(t.shape) not in (shared, (1,) + shared,
                                   (lights,) + shared):
        raise ValueError(f"scan_readout_cuda: {name} must be a contiguous "
                         f"float32 {shared} or {(lights,) + shared} tensor "
                         f"on {dev}")
    return t, t.dim() == len(shared) + 1 and t.shape[0] != 1


def scan_readout_cuda(scene, walk, lx, ly, light_position, light_radius,
                      light_ramp_length, quality: QualitySettings, trace_z,
                      height: int, width: int, render_scale: float,
                      halvings: int, use_cols: bool, pixel_z=None,
                      pixel_offset_xy=None, max_trace_distance=None,
                      world_offset=None):
    """One K2 launch on the current stream: `scan_shadows.scan_readout`
    (see there for the arguments) -> (L, height, width) float32. CUDA
    tensors only; the lanes' arrays may be strided views, the walk and
    the per-pixel arrays are contiguous. A ColumnField's maps are packed
    once a new set (`columns_kernel.packed`), an SdfVolume's taps once a
    new volume (`cone_trace_kernel.packed_volume`)."""
    dev = light_position.device
    if not torch.is_tensor(walk) or walk.device != dev or \
            walk.dtype != torch.float32 or not walk.is_contiguous() or \
            walk.dim() != 5 or walk.shape[0] != 4 or \
            walk.shape[1] != (6 if use_cols else 3):
        raise ValueError("scan_readout_cuda: the walk must be K1's "
                         "contiguous float32 (4, C, L, nh, nw) on "
                         f"{dev}, C = {6 if use_cols else 3}")
    _, channels, lights, nh, nw = walk.shape
    if (nh << halvings, nw << halvings) != (height, width):
        raise ValueError(f"scan_readout_cuda: a {nh} x {nw} walk is not "
                         f"{halvings} halvings of {height} x {width}")
    lanes = [_lane("lx", lx, lights, dev), _lane("ly", ly, lights, dev),
             _lane("light_position", light_position, lights, dev, 3),
             _lane("light_radius", light_radius, lights, dev),
             _lane("light_ramp_length", light_ramp_length, lights, dev)]
    mtd = None if max_trace_distance is None else _lane(
        "max_trace_distance", max_trace_distance, lights, dev)
    if not torch.is_tensor(trace_z) or trace_z.device != dev or \
            trace_z.dtype != torch.float32 or trace_z.numel() != 1:
        raise ValueError(f"scan_readout_cuda: trace_z must be one float32 "
                         f"on {dev}")
    if world_offset is not None and (
            not torch.is_tensor(world_offset) or world_offset.device != dev
            or world_offset.dtype != torch.float32
            or tuple(world_offset.shape) != (2,)
            or not world_offset.is_contiguous()):
        raise ValueError(f"scan_readout_cuda: world_offset must be a "
                         f"contiguous float32 (2,) tensor on {dev}")
    pz, pz_lane = _image("pixel_z", pixel_z, lights, height, width, dev)
    oxy, oxy_lane = _image("pixel_offset_xy", pixel_offset_xy, lights,
                           height, width, dev, (2,))
    if dev.type != "cuda":
        raise ValueError(f"scan_readout_cuda: no kernel for device {dev}")

    name, kind, f_ints, f_floats, f_tensors = _field(scene, quality,
                                                     use_cols)
    if any(t.device != dev for t in f_tensors if t is not None):
        raise ValueError(f"scan_readout_cuda: the field is not on {dev}")
    scene_floats = k12.analytic_smem_bytes(f_ints) // 4 \
        if name == "analytic" else 0
    plan = launch_plan(height, width, lights, halvings, name, scene_floats)
    out = torch.empty((lights, height, width), dtype=torch.float32,
                      device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    ptr_list = [walk.data_ptr()] + [t.data_ptr() for t in lanes] + [
        ptr(mtd), trace_z.data_ptr(), ptr(world_offset), ptr(pz), ptr(oxy),
        out.data_ptr()] + [ptr(t) for t in f_tensors]
    q = quality
    power = q.occlusion_to_opacity_power
    inv_rs = 1.0 / max(render_scale, 1e-6)
    # torch divides a card tensor by a Python scalar as a product with the
    # scalar's float32 reciprocal.
    inv_range = np.float32(1.0) / np.float32(UNSHADOWED_THRESHOLD
                                             - FULLY_SHADOWED_THRESHOLD)
    lx_, ly_, light, radius, ramp = lanes
    ints = [channels, lights, nh, nw, height, width, halvings,
            min(max(int(q.scan_refine_samples), 0), 3), int(pz_lane),
            int(oxy_lane), pow_mode(power), plan["smem_bytes"],
            lx_.stride(0), ly_.stride(0), light.stride(0), light.stride(1),
            radius.stride(0), ramp.stride(0),
            0 if mtd is None else mtd.stride(0), kind] + f_ints
    floats = [render_scale, inv_rs, inv_rs * inv_rs, q.max_cone_radius,
              q.cone_growth_factor, power, float(inv_range), MIN_CONE_RADIUS,
              HACK_DISTANCE_OFFSET, FULLY_SHADOWED_THRESHOLD, _TOP_FILL,
              _BOT_FILL] + f_floats
    LIBRARY.launch("k2_scan_readout", "scan_readout", dev,
                   (ctypes.c_void_p * len(ptr_list))(*ptr_list),
                   (ctypes.c_longlong * len(ints))(*ints),
                   (ctypes.c_float * len(floats))(*floats),
                   plan["instance"])
    return out


def block_plan(height: int, width: int, lights: int, halvings: int,
               instance: str, scene_floats: int = 0) -> dict:
    """`launch_plan` and, on the current card, the instance's threads,
    registers and spilled bytes a thread and resident blocks an SM."""
    plan = launch_plan(height, width, lights, halvings, instance,
                       scene_floats)
    out = (ctypes.c_int * 4)()
    LIBRARY.call("scan_readout_plan", plan["instance"], plan["smem_bytes"],
                 out)
    return dict(plan, **dict(zip(("threads", "registers", "spill_bytes",
                                  "blocks_per_sm"), out)))
