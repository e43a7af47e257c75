"""The cone-trace march on the card: the CUDA source `csrc/cone_trace.cu`
(K12), its wrapper and its argument packing.

K12 replaces the XLA `lax.while_loop` of `illuminant_tpu/lighting/
cone_trace.py:cone_trace` (:42-148) and, in the port, the plain loop of
`lighting/cone_trace.py:cone_trace_reference`, which is its plain version:
one thread a ray marches in registers until its own loop ends, with no
host read and no chunking. The field is sampled in the kernel: the
trilinear SdfVolume, the closed-form AnalyticScene (primitives and
extruded polygons), or the ColumnField reconstruction (`csrc/
column_query.cuh`, shared with K7 and K10). The source's header says what
bounds it and what the design does about it.

Rays are (light, point) pairs: `launch_plan` splits the broadcast shape
of the arguments into lights (its first axis, when it has two or more)
and points (the rest) and gives each argument an element stride per
light, per point and per component, 0 where it is broadcast, so no
argument is copied unless its broadcast cannot be written so (then one
contiguous copy of it). `launch_plan` is pure and runs on the CPU;
`cone_trace_cuda` launches the kernel or raises, and `block_plan` reports
the launch's block on the card. The library is compiled from the
repository's source at first use (`core/cuda_build`).
"""

from __future__ import annotations

import ctypes

import torch

from ..core import cuda_build
from ..core.config import QualitySettings
from ..sdf import columns, columns_kernel
from ..sdf.analytic import AnalyticScene
from ..sdf.columns import ColumnField
from ..sdf.volume import SdfVolume

_SOURCE = cuda_build.CSRC / "cone_trace.cu"
_LIBRARY = cuda_build.library_path(_SOURCE)

# The source's FieldKind.
FIELD_KINDS = {SdfVolume: 0, AnalyticScene: 1, ColumnField: 2}
# Floats of a primitive record (the source's kPrimitiveRecord): type,
# rotated, center xyz, size xyz, quaternion xyzw.
PRIMITIVE_RECORD = 12
# The order of the per-ray arguments in the source's stride table.
RAY_ARGS = ("center", "radius", "ramp", "origin", "enable")

# Launches since import (or since a caller reset it): the wrapper adds one
# where it launches the kernel and nowhere else.
LAUNCHES = 0

_lib = None


def build():
    """Compile csrc/cone_trace.cu unless an up-to-date library is there."""
    return cuda_build.build(_SOURCE, _LIBRARY)


def _library():
    global _lib
    if _lib is None:
        ptr = ctypes.c_void_p
        i64p = ctypes.POINTER(ctypes.c_longlong)
        _lib = cuda_build.load(_SOURCE, _LIBRARY, {
            "cone_trace": [ctypes.POINTER(ctypes.c_void_p), i64p, i64p,
                           ctypes.POINTER(ctypes.c_float), ptr],
            "cone_trace_plan": [ctypes.c_int,
                                ctypes.POINTER(ctypes.c_int)]})
    return _lib


def _ray_view(t, shape, lights: int, points: int, vec: bool):
    """`t` broadcast to `shape` (+ (3,)) as an (L, P[, 3]) view, or a
    contiguous copy where the broadcast has no such view -> (tensor,
    (stride per light, per point, per component))."""
    full = tuple(shape) + ((3,) if vec else ())
    target = (lights, points) + ((3,) if vec else ())
    e = t.expand(full)
    try:
        v = e.view(target)
    except RuntimeError:
        v = e.reshape(target).contiguous()
    return v, (v.stride(0), v.stride(1), v.stride(2) if vec else 0)


def analytic_records(scene: AnalyticScene):
    """The scene's primitives as (n, PRIMITIVE_RECORD) float32 records in
    the order `distance_p` walks them, built on the scene's device with
    tensor operations (no host read) -> (records, batched). `batched`:
    more primitives than the unroll limit, where the plain version
    evaluates every slot of each group (pads too) in its batched forms."""
    counts = scene._counts()
    batched = sum(counts) > scene._UNROLL_LIMIT
    if batched:
        counts = tuple(int(c.shape[0]) for c in scene.centers)
    f32 = torch.float32
    parts = []
    for gi, type_id in enumerate(scene.group_types):
        n = counts[gi]
        if n == 0:
            continue
        c = scene.centers[gi]
        # Fills, not host copies: the records build inside a CUDA graph.
        head = [torch.full((n, 1), v, dtype=f32, device=c.device)
                for v in (float(type_id),
                          1.0 if scene.group_rotated[gi] else 0.0)]
        parts.append(torch.cat(
            head + [c[:n].to(f32), scene.sizes[gi][:n].to(f32),
                    scene.rotations[gi][:n].to(f32)], dim=1))
    if not parts:
        dev = (scene.centers[0].device if scene.centers
               else torch.device("cpu"))
        return torch.zeros((0, PRIMITIVE_RECORD), dtype=f32,
                           device=dev), batched
    return torch.cat(parts, dim=0).contiguous(), batched


def field_scalars(volume):
    """The field's kind, its integer and float constants in the source's
    order, and the tensors whose pointers follow them (the ColumnField's
    planar maps, which the launch packs first)."""
    kind = FIELD_KINDS.get(type(volume))
    if kind is None:
        raise TypeError(f"unsupported field {type(volume).__name__}")
    f32 = torch.float32
    if isinstance(volume, SdfVolume):
        c = volume.config
        ez = float(c.virtual_depth)
        data = volume.data.to(f32).contiguous()
        mvz = torch.as_tensor(volume.max_valid_z, dtype=f32,
                              device=data.device).reshape(())
        return (kind, [c.slice_count, c.slice_height, c.slice_width],
                [float(c.virtual_width), float(c.virtual_height), ez,
                 float(c.z_offset), c.slice_count / ez, c.scale_x,
                 c.scale_y], [data, mvz])
    if isinstance(volume, AnalyticScene):
        records, batched = analytic_records(volume)
        poly = volume.polygons
        if poly is None:
            tensors = [records] + [None] * 4
            n_poly, edges = 0, 0
        else:
            tensors = [records] + [t.to(f32).contiguous() for t in (
                poly.vertices, poly.next_vertices, poly.z_range,
                poly.active)]
            n_poly, edges = poly.capacity, int(poly.vertices.shape[1])
        return (kind, [records.shape[0], int(batched), n_poly, edges],
                [float(volume.maximum_distance)], tensors)
    _, hc, wc = volume.maps_c.shape
    return (kind, [hc, wc], [float(v) for v in columns.query_geometry(
        volume)], [volume.maps_c])


def launch_plan(volume, light_center, light_radius, light_ramp_length,
                shaded_position, enable, quality: QualitySettings,
                raw: bool = False) -> dict:
    """Everything a K12 launch is given, with the arguments as
    `cone_trace` takes them (see there): the broadcast ray `shape`,
    `lights` x `points`, each per-ray argument as its (L, P[, 3]) view
    and its strides (`views`, `strides`, in RAY_ARGS order), the field's
    `kind`, and the `ints` and `floats` of the source's table. Pure: no
    kernel, no host read; runs on any device."""
    dev = shaded_position.device
    f32 = torch.float32
    radius = torch.as_tensor(light_radius, dtype=f32, device=dev)
    ramp = torch.as_tensor(light_ramp_length, dtype=f32, device=dev)
    enable = torch.as_tensor(enable, device=dev).to(torch.bool)
    center = light_center.to(f32)
    origin = shaded_position.to(f32)
    shape = torch.broadcast_shapes(origin.shape[:-1], center.shape[:-1],
                                   enable.shape, radius.shape, ramp.shape)
    lights = int(shape[0]) if len(shape) >= 2 else 1
    n = 1
    for s in shape:
        n *= int(s)
    points = n // lights if lights else 0
    views, strides = {}, {}
    for name, t, vec in (("center", center, True), ("radius", radius, False),
                         ("ramp", ramp, False), ("origin", origin, True),
                         ("enable", enable, False)):
        views[name], strides[name] = _ray_view(t, shape, lights, points, vec)
    kind, f_ints, f_floats, f_tensors = field_scalars(volume)
    q = quality
    ints = [lights, points, kind, int(q.max_step_count), int(bool(raw))] \
        + [int(v) for v in f_ints]
    floats = [max(1.0, q.min_step_size), q.long_step_factor,
              q.max_cone_radius, q.cone_growth_factor,
              q.occlusion_to_opacity_power] + f_floats
    return dict(shape=tuple(shape), lights=lights, points=points,
                views=views, strides=strides, kind=kind, ints=ints,
                floats=[float(v) for v in floats], field_tensors=f_tensors)


def cone_trace_cuda(volume, light_center, light_radius, light_ramp_length,
                    shaded_position, enable, quality: QualitySettings,
                    raw: bool = False, with_steps: bool = False):
    """One K12 launch on the current stream -> the visibility of the
    broadcast ray shape (and, `with_steps`, each ray's steps left, as
    float32). CUDA tensors only; a ColumnField's maps are packed first
    (`columns_kernel.pack_maps`, one launch)."""
    global LAUNCHES
    plan = launch_plan(volume, light_center, light_radius, light_ramp_length,
                       shaded_position, enable, quality, raw)
    dev = shaded_position.device
    tensors = list(plan["views"].values()) + [
        t for t in plan["field_tensors"] if t is not None]
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"cone_trace_cuda: no kernel for device {dev} (every "
                         "tensor must lie on one CUDA device)")
    shape = plan["shape"]
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    steps = (torch.empty(shape, dtype=torch.float32, device=dev)
             if with_steps else None)
    if out.numel() == 0:
        return (out, steps) if with_steps else out
    field_tensors = plan["field_tensors"]
    if plan["kind"] == FIELD_KINDS[ColumnField]:
        field_tensors = [columns_kernel.pack_maps(field_tensors[0])]
    ptr_list = [plan["views"][name].data_ptr() for name in RAY_ARGS]
    ptr_list += [out.data_ptr(), None if steps is None else steps.data_ptr()]
    ptr_list += [None if t is None else t.data_ptr() for t in field_tensors]
    stride_list = [s for name in RAY_ARGS for s in plan["strides"][name]]
    ptrs = (ctypes.c_void_p * len(ptr_list))(*ptr_list)
    strides = (ctypes.c_longlong * len(stride_list))(*stride_list)
    ints = (ctypes.c_longlong * len(plan["ints"]))(*plan["ints"])
    floats = (ctypes.c_float * len(plan["floats"]))(*plan["floats"])
    with torch.cuda.device(dev):
        err = _library().cone_trace(
            ptrs, strides, ints, floats,
            torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(err, "cone_trace")
    LAUNCHES += 1
    return (out, steps) if with_steps else out


def block_plan(volume) -> dict:
    """The block of a K12 launch on `volume`'s field kind, on the current
    card: threads, registers and spilled bytes a thread, resident blocks
    an SM."""
    kind = FIELD_KINDS.get(type(volume))
    if kind is None:
        raise TypeError(f"unsupported field {type(volume).__name__}")
    out = (ctypes.c_int * 4)()
    cuda_build.check(_library().cone_trace_plan(kind, out),
                     "cone_trace_plan")
    return dict(zip(("threads", "registers", "spill_bytes",
                     "blocks_per_sm"), out))
