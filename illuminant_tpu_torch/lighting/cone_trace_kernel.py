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
contiguous copy of it). Where the rays are (L, H, W), a block takes a
16 x 16 square of one light's points (`ray_blocks` is that map in
PyTorch). Each field kind has its kernel instances (`INSTANCES`): the
SdfVolume read from its packed taps (`packed_volume`, one launch a new
volume; `pack_volume_reference` is its plain version), the
AnalyticScene's arrays staged in shared memory or read from device
memory, the ColumnField. `launch_plan` is pure and runs on
the CPU; `cone_trace_cuda` launches the kernel or raises, and
`block_plan` reports the launch's block on the card. The library is
compiled from the repository's source at first use (`core/cuda_build`).
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

_ptr, _i32 = ctypes.c_void_p, ctypes.c_int
_i64p = ctypes.POINTER(ctypes.c_longlong)
LIBRARY = cuda_build.Library("cone_trace.cu", {
    "cone_trace": [ctypes.POINTER(ctypes.c_void_p), _i64p, _i64p,
                   ctypes.POINTER(ctypes.c_float), _i32, _ptr],
    "cone_trace_pack_volume": [_ptr, _i32, _i32, _i32, _ptr, _ptr],
    "cone_trace_plan": [_i32, _i32, ctypes.POINTER(ctypes.c_int)]},
    ["k12_cone_trace", "k12_volume_pack"])

# The field kinds of the source's table.
FIELD_KINDS = {SdfVolume: 0, AnalyticScene: 1, ColumnField: 2}
# The source's kernel instances (its Instance enum).
INSTANCES = {"volume": 0, "analytic": 1, "column": 2, "analytic_global": 3}
# The source's kThreads and kTile.
THREADS = 256
TILE = 16
# The AnalyticScene's arrays go to shared memory up to this many bytes
# (at most the source's kAnalyticSmemMax), else stay in device memory.
ANALYTIC_SMEM_MAX = 48 * 1024
# Floats of a primitive record (the source's kPrimitiveRecord): type,
# rotated, center xyz, size xyz, quaternion xyzw.
PRIMITIVE_RECORD = 12
# The order of the per-ray arguments in the source's stride table.
RAY_ARGS = ("center", "radius", "ramp", "origin", "enable")


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


def pack_volume_reference(data):
    """The plain version of the volume pack: (S, H, W, 4) float32, each
    texel's taps (y, x), (y, x1), (y1, x), (y1, x1) of its slice with x1 =
    min(x + 1, W - 1) and y1 = min(y + 1, H - 1), the four values
    `sdf/sampling.py:sample` reads for a sample whose clipped floor is
    (y, x)."""
    _, h, w = data.shape
    x1 = torch.clamp(torch.arange(w, device=data.device) + 1, max=w - 1)
    y1 = torch.clamp(torch.arange(h, device=data.device) + 1, max=h - 1)
    return torch.stack([data, data[:, :, x1], data[:, y1, :],
                        data[:, y1][:, :, x1]], dim=-1)


def pack_volume(data):
    """One launch of the source's pack: `pack_volume_reference(data)` on
    the card, (S, H, W, 4) float32. CUDA tensors only."""
    if data.device.type != "cuda" or data.dtype != torch.float32 or \
            data.dim() != 3 or not data.is_contiguous():
        raise ValueError("pack_volume: a contiguous (S, H, W) float32 CUDA "
                         "tensor")
    if data.numel() >= 2 ** 31:
        raise ValueError(f"pack_volume: {data.numel()} elements reach 2^31")
    out = torch.empty(tuple(data.shape) + (4,), dtype=torch.float32,
                      device=data.device)
    LIBRARY.launch("k12_volume_pack", "cone_trace_pack_volume", data.device,
                   data.data_ptr(), *data.shape, out.data_ptr())
    return out


def packed_volume(volume: SdfVolume):
    """The volume's pack, built at the first march on it and kept on the
    volume; built again once its data changes (another tensor, or the same
    one written in place)."""
    data = volume.data.to(torch.float32).contiguous()
    key = (data.data_ptr(), data._version, tuple(data.shape))
    kept = getattr(volume, "_tap_pack", None)
    if kept is not None and kept[0] == key:
        return kept[1]
    pack = pack_volume(data)
    object.__setattr__(volume, "_tap_pack", (key, pack))
    return pack


def analytic_smem_bytes(ints) -> int:
    """Bytes of an AnalyticScene's arrays (its `field_scalars` ints:
    count, batched, polygons, edges), as the source stages them."""
    count, _, n_poly, edges = ints
    return 4 * (count * PRIMITIVE_RECORD + 4 * n_poly * edges + 3 * n_poly)


def instance_for(kind: int, f_ints) -> int:
    """The kernel instance a launch on field `kind` takes."""
    if kind == FIELD_KINDS[SdfVolume]:
        return INSTANCES["volume"]
    if kind == FIELD_KINDS[AnalyticScene]:
        return INSTANCES["analytic" if analytic_smem_bytes(f_ints)
                         <= ANALYTIC_SMEM_MAX else "analytic_global"]
    return INSTANCES["column"]


def field_scalars(volume):
    """The field's kind, its integer and float constants in the source's
    order, and the tensors whose pointers follow them (the ColumnField's
    planar maps and the SdfVolume's data, whose packs the launch builds
    or finds)."""
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
    if n >= 2 ** 31:
        raise ValueError(f"cone_trace: {n} rays reach 2^31")
    views, strides = {}, {}
    for name, t, vec in (("center", center, True), ("radius", radius, False),
                         ("ramp", ramp, False), ("origin", origin, True),
                         ("enable", enable, False)):
        views[name], strides[name] = _ray_view(t, shape, lights, points, vec)
        reach = sum((size - 1) * stride for size, stride
                    in zip(views[name].shape, views[name].stride()))
        if reach >= 2 ** 31:
            raise ValueError(f"cone_trace: {name} reaches 2^31 elements")
    kind, f_ints, f_floats, f_tensors = field_scalars(volume)
    if any(t is not None and t.numel() >= 2 ** 31 for t in f_tensors):
        raise ValueError("cone_trace: a field array reaches 2^31 elements")
    # An (L, H, W) ray shape: a block takes a 16 x 16 square of a light's
    # (H, W) points (else 256 rays in order).
    image = (int(shape[1]), int(shape[2])) if len(shape) == 3 else (0, 0)
    q = quality
    ints = [lights, points, kind, int(q.max_step_count), int(bool(raw)),
            *image] + [int(v) for v in f_ints]
    floats = [max(1.0, q.min_step_size), q.long_step_factor,
              q.max_cone_radius, q.cone_growth_factor,
              q.occlusion_to_opacity_power] + f_floats
    return dict(shape=tuple(shape), lights=lights, points=points,
                views=views, strides=strides, kind=kind, ints=ints,
                floats=[float(v) for v in floats], field_tensors=f_tensors,
                instance=instance_for(kind, f_ints), image=image)


def ray_blocks(plan) -> torch.Tensor:
    """The rays each block of a launch takes, as the source maps its
    threads: (blocks, THREADS) int64 ray indices l * points + p, -1 for a
    thread past the rays or outside the image. With the plan's `image`
    (H, W) a block takes a 16 x 16 square of one light's points, blocks
    ordered light, tile row, tile column; else 256 rays in order. Pure."""
    lights, points = plan["lights"], plan["points"]
    h, w = plan["image"]
    if w == 0:
        i = torch.arange(-(-lights * points // THREADS) * THREADS)
        return torch.where(i < lights * points, i, -1).reshape(-1, THREADS)
    tiles_y, tiles_x = -(-h // TILE), -(-w // TILE)
    b = torch.arange(lights * tiles_y * tiles_x)[:, None]
    t = torch.arange(THREADS)[None]
    light, rest = b // (tiles_y * tiles_x), b % (tiles_y * tiles_x)
    y = rest // tiles_x * TILE + t // TILE
    x = rest % tiles_x * TILE + t % TILE
    return torch.where((y < h) & (x < w), light * points + y * w + x, -1)


def cone_trace_cuda(volume, light_center, light_radius, light_ramp_length,
                    shaded_position, enable, quality: QualitySettings,
                    raw: bool = False, with_steps: bool = False):
    """One K12 launch on the current stream -> the visibility of the
    broadcast ray shape (and, `with_steps`, each ray's steps left, as
    float32). CUDA tensors only; a ColumnField's maps are packed once a
    new set of maps (`columns_kernel.packed`, one launch), an SdfVolume's
    taps at the first march on it (`packed_volume`, one launch)."""
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
        field_tensors = [columns_kernel.packed(volume)]
    elif plan["kind"] == FIELD_KINDS[SdfVolume]:
        field_tensors = [packed_volume(volume), field_tensors[1]]
    ptr_list = [plan["views"][name].data_ptr() for name in RAY_ARGS]
    ptr_list += [out.data_ptr(), None if steps is None else steps.data_ptr()]
    ptr_list += [None if t is None else t.data_ptr() for t in field_tensors]
    stride_list = [s for name in RAY_ARGS for s in plan["strides"][name]]
    ptrs = (ctypes.c_void_p * len(ptr_list))(*ptr_list)
    strides = (ctypes.c_longlong * len(stride_list))(*stride_list)
    ints = (ctypes.c_longlong * len(plan["ints"]))(*plan["ints"])
    floats = (ctypes.c_float * len(plan["floats"]))(*plan["floats"])
    LIBRARY.launch("k12_cone_trace", "cone_trace", dev, ptrs, strides, ints,
                   floats, plan["instance"])
    return (out, steps) if with_steps else out


def block_plan(volume) -> dict:
    """The block of a K12 launch on `volume`, on the current card: the
    kernel instance, threads, shared memory, registers and spilled bytes
    a thread, resident blocks an SM."""
    kind, f_ints, _, _ = field_scalars(volume)
    instance = instance_for(kind, f_ints)
    smem = analytic_smem_bytes(f_ints) \
        if instance == INSTANCES["analytic"] else 0
    out = (ctypes.c_int * 4)()
    LIBRARY.call("cone_trace_plan", instance, smem, out)
    name = next(k for k, v in INSTANCES.items() if v == instance)
    return dict(instance=name, smem_bytes=smem,
                **dict(zip(("threads", "registers", "spill_bytes",
                            "blocks_per_sm"), out)))
