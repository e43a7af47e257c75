"""The particles' collision integrate on the card: the CUDA source
`csrc/collide_integrate.cu` (K4), its wrapper, its uniform table and its
launch plan.

K4 replaces, for CUDA tensors, the eager body of
`integrate.integrate_with_distance_field` with
`render_data.compute_render_data` (about a thousand small kernels a
call): one launch a call, one thread a slot, the slot's rows read once
and its four output rows written once. The JAX function it is held to is
`illuminant_tpu/particles/integrate.py:integrate_with_distance_field`,
through the eager body, which stays the plain version (CPU tensors, and
the fields the kernel does not take). The source's header says what
bounds it and what the design does about it.

`takes` says whether a call goes to the kernel: CUDA tensors on an
AnalyticScene or a ColumnField, at any count of substeps. A scene within
its unroll limit and without polygons is staged in shared memory
("analytic"); any other scene is read from device memory as K12's
records and polygons ("analytic_global"). `uniform_table` lists the
uniform tensors a launch reads, in the source's segment order.
`launch_plan` is pure and runs on the CPU; `integrate_cuda` launches the
kernel or raises, and `block_plan` reports an instance's block on the
card. The library is compiled from the repository's source at first use
(`core/cuda_build`).
"""

from __future__ import annotations

import ctypes

import torch

from ..core import cuda_build
from ..lighting.cone_trace_kernel import analytic_records
from ..sdf import columns, columns_kernel
from ..sdf.analytic import AnalyticScene
from ..sdf.columns import ColumnField
from .render_data import RenderDataUniforms
from .state import ParticleState, SystemUniforms

LIBRARY = cuda_build.Library("collide_integrate.cu", {
    "collide_integrate": [ctypes.POINTER(ctypes.c_void_p),
                          ctypes.POINTER(ctypes.c_longlong),
                          ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                          ctypes.c_void_p],
    "collide_integrate_plan": [ctypes.c_int, ctypes.c_int,
                               ctypes.POINTER(ctypes.c_int)]},
    ["k4_integrate"])

# The source's field kinds (its Kind enum); an instance is kind *
# VARIANTS + the substeps' variant: the count for 0 to MAX_SUBSTEPS
# (unrolled), RUNTIME_SUBSTEPS for any larger count.
FIELD_KINDS = {"analytic": 0, "column": 1, "analytic_global": 2}
MAX_SUBSTEPS = 3
RUNTIME_SUBSTEPS = 4
VARIANTS = 5
THREADS = 256
# A scene the kernel stages: at most the unroll limit's primitives in at
# most MAX_GROUPS type groups (the source's kMaxPrimitives, kMaxGroups).
MAX_PRIMITIVES = AnalyticScene._UNROLL_LIMIT
MAX_GROUPS = 8
# Floats of a primitive record: type, rotated, center xyz, size xyz,
# quaternion xyzw.
PRIMITIVE_RECORD = 12
# The tensors of an "analytic_global" launch after the records: the
# polygons' (HeightVolumes) vertices, next vertices, z range, active.
POLYGON_TENSORS = ("vertices", "next_vertices", "z_range", "active")
# The uniform table (the source's Segment enum): each segment's name and
# the floats its slot of the block's copy holds, in order.
UNIFORM_SEGMENTS = (
    ("global_settings", 4), ("collision_settings", 4),
    ("color_from_life.head", 4), ("color_from_life.points", 16),
    ("color_from_velocity.head", 4), ("color_from_velocity.points", 16),
    ("size_from_life.head", 4), ("size_from_life.points", 16),
    ("size_from_velocity.head", 4), ("size_from_velocity.points", 16),
    ("rotation_from_life_and_index", 2), ("velocity_rotation", 1),
    ("life_ramp_settings", 4))
UNIFORM_FLOATS = 96
# Each segment's offset in the block's copy (the source's kSegmentOffset).
SEGMENT_OFFSETS = {name: sum(size for _, size in UNIFORM_SEGMENTS[:i])
                   for i, (name, _) in enumerate(UNIFORM_SEGMENTS)}
BEZIERS = ("color_from_life", "color_from_velocity", "size_from_life",
           "size_from_velocity")
# Bytes a slot moves: position, velocity and colour rows read, position,
# velocity, render colour and render data rows written.
BYTES_PER_SLOT = 7 * 16


def takes(device, volume) -> bool:
    """True where `integrate_with_distance_field` runs K4: tensors on a
    CUDA device, an AnalyticScene or a ColumnField. The CPU and a bare
    SdfVolume run the eager body."""
    return (torch.device(device).type == "cuda"
            and isinstance(volume, (AnalyticScene, ColumnField)))


def _flat(t, what: str, size: int):
    t = torch.as_tensor(t).to(torch.float32).contiguous().reshape(-1)
    if t.numel() > size:
        raise ValueError(f"collide_integrate: {what} holds {t.numel()} "
                         f"floats, its segment {size}")
    return t


def uniform_table(su: SystemUniforms, rd: RenderDataUniforms) -> list:
    """The uniform tensors of a launch in UNIFORM_SEGMENTS order, each
    flattened float32 (no copy where it already is one), None where the
    uniforms have none (read as zeros). A colour bezier has 1 or 4
    channels."""
    sizes = dict(UNIFORM_SEGMENTS)
    out = [_flat(su.global_settings, "global_settings", 4),
           _flat(su.collision_settings, "collision_settings", 4)]
    for name in BEZIERS:
        b = getattr(rd, name)
        if b.points.dim() != 2 or b.points.shape[0] != 4 or (
                name.startswith("color") and b.channels not in (1, 4)):
            raise ValueError(f"collide_integrate: {name} has points "
                             f"{tuple(b.points.shape)}")
        out.append(_flat(b.range_and_count, f"{name}.head", 4))
        out.append(_flat(b.points, f"{name}.points",
                         sizes[f"{name}.points"]))
    out.append(_flat(rd.rotation_from_life_and_index,
                     "rotation_from_life_and_index", 2))
    out.append(None if rd.velocity_rotation is None
               else _flat(rd.velocity_rotation, "velocity_rotation", 1))
    out.append(None if rd.life_ramp is None
               else _flat(rd.life_ramp_settings, "life_ramp_settings", 4))
    return out


def _render_ints(rd: RenderDataUniforms) -> list:
    """The beziers' channels and constant flags, the velocity-rotation
    gate, the ramp's height and width (0 without one)."""
    use_vrot = bool(rd.use_velocity_rotation
                    and rd.velocity_rotation is not None)
    ramp_hw = (0, 0) if rd.life_ramp is None else tuple(
        int(v) for v in rd.life_ramp.shape[:2])
    return ([getattr(rd, b).channels for b in BEZIERS]
            + [int(bool(getattr(rd, b).is_constant)) for b in BEZIERS]
            + [int(use_vrot), *ramp_hw])


def _analytic_groups(scene: AnalyticScene):
    """The scene's type groups as the kernel stages them: (type, rotated,
    live primitives, centers, sizes, rotations)."""
    counts = scene._counts()
    return [(type_id, bool(scene.group_rotated[gi]), counts[gi],
             scene.centers[gi], scene.sizes[gi], scene.rotations[gi])
            for gi, type_id in enumerate(scene.group_types)
            if counts[gi] > 0]


def _staged(scene: AnalyticScene) -> bool:
    """True for a scene the kernel stages: no polygons, at most
    MAX_PRIMITIVES live primitives in at most MAX_GROUPS groups."""
    groups = _analytic_groups(scene)
    return (scene.polygons is None and len(groups) <= MAX_GROUPS
            and sum(g[2] for g in groups) <= MAX_PRIMITIVES)


def launch_plan(n: int, volume, substeps: int, maximum_z: float = 1e9,
                first_slot: int = 0) -> dict:
    """Everything a K4 launch on `n` slots is given but the tensors' data:
    `blocks`, `threads`, the field `kind`, the `instance`, its dynamic
    `smem_bytes`, the field's `ints` and `floats` in the source's order
    and the field tensors whose pointers follow the uniforms
    (`field_tensors`: a staged scene's groups' centers, sizes and
    rotations; another scene's records and polygon tensors, None without
    polygons; None for a ColumnField's pack, which the launch finds).
    Pure: no K4 launch, no host read (a scene read from device memory has
    its records built, `analytic_records`); runs on any device. Raises
    where `takes` would not, and for a negative count of substeps."""
    if isinstance(volume, AnalyticScene) and not _staged(volume):
        records, batched = analytic_records(volume)
        poly = volume.polygons
        kind = FIELD_KINDS["analytic_global"]
        smem = 0
        ints = [records.shape[0], int(batched), 0, 0]
        tensors = [records] + [None] * len(POLYGON_TENSORS)
        if poly is not None:
            ints[2:] = [poly.capacity, int(poly.vertices.shape[1])]
            tensors[1:] = [getattr(poly, name) for name in POLYGON_TENSORS]
        floats = [float(volume.maximum_distance)]
    elif isinstance(volume, AnalyticScene):
        groups = _analytic_groups(volume)
        count = sum(g[2] for g in groups)
        kind = FIELD_KINDS["analytic"]
        smem = 4 * PRIMITIVE_RECORD * count
        ints, tensors = [count, len(groups)], []
        for type_id, rotated, k, c, s, q in groups:
            ints += [k, type_id, int(rotated)]
            tensors += [c, s, q]
        ints += [0, 0, 0] * (MAX_GROUPS - len(groups))
        floats = [float(volume.maximum_distance)]
    elif isinstance(volume, ColumnField):
        kind = FIELD_KINDS["column"]
        _, hc, wc = volume.maps_c.shape
        ints, smem, tensors = [hc, wc], 0, [None]
        floats = [float(v) for v in columns.query_geometry(volume)]
    else:
        raise TypeError(f"collide_integrate: no kernel for a "
                        f"{type(volume).__name__}")
    if substeps < 0:
        raise ValueError(f"collide_integrate: {substeps} substeps")
    if first_slot < 0 or first_slot + n > 2 ** 31:
        raise ValueError(f"collide_integrate: slots {first_slot} .. "
                         f"{first_slot + n} leave int32")
    variant = min(int(substeps), RUNTIME_SUBSTEPS)
    return dict(blocks=-(-n // THREADS), threads=THREADS, kind=kind,
                instance=kind * VARIANTS + variant, smem_bytes=smem,
                ints=ints, floats=floats, field_tensors=tensors,
                n=n, first_slot=first_slot, substeps=int(substeps),
                maximum_z=float(maximum_z))


def _rows(t):
    """A contiguous float32 tensor, its data aligned for the kernel's
    16-byte loads."""
    t = t.to(torch.float32).contiguous()
    if t.data_ptr() % 16:
        t = t.clone()
    return t


def integrate_cuda(state: ParticleState, su: SystemUniforms,
                   rd: RenderDataUniforms, volume, maximum_z: float = 1e9,
                   substeps: int = MAX_SUBSTEPS,
                   first_slot: int = 0) -> ParticleState:
    """One K4 launch on the current stream: the state after
    `integrate_with_distance_field` with its arguments (see there). CUDA
    tensors only; a ColumnField's maps are packed once a new set of maps
    (`columns_kernel.packed`, one launch)."""
    n = state.capacity
    plan = launch_plan(n, volume, int(substeps), maximum_z, first_slot)
    dev = state.position.device
    rows = [_rows(t) for t in (state.position, state.velocity, state.color)]
    if any(tuple(t.shape) != (n, 4) for t in rows):
        raise ValueError("collide_integrate: the state rows must be (N, 4)")
    table = uniform_table(su, rd)
    ramp = None if rd.life_ramp is None else _rows(rd.life_ramp)
    if plan["kind"] == FIELD_KINDS["column"]:
        field_tensors = [columns_kernel.packed(volume)]
    else:
        field_tensors = [None if t is None else _rows(t)
                         for t in plan["field_tensors"]]
    tensors = rows + [t for t in table + [ramp] + field_tensors
                      if t is not None]
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"collide_integrate: no kernel for device {dev} "
                         "(every tensor must lie on one CUDA device)")
    outs = [torch.empty((n, 4), dtype=torch.float32, device=dev)
            for _ in range(4)]
    if n > 0:
        ptr_list = [t.data_ptr() for t in rows + outs]
        ptr_list += [None if t is None else t.data_ptr()
                     for t in table + [ramp] + field_tensors]
        int_list = [n, first_slot, plan["substeps"]]
        int_list += [0 if t is None else t.numel() for t in table]
        int_list += _render_ints(rd) + plan["ints"]
        float_list = [plan["maximum_z"]] + plan["floats"]
        ptrs = (ctypes.c_void_p * len(ptr_list))(*ptr_list)
        ints = (ctypes.c_longlong * len(int_list))(*int_list)
        floats = (ctypes.c_float * len(float_list))(*float_list)
        LIBRARY.launch("k4_integrate", "collide_integrate", dev, ptrs, ints,
                       floats, plan["instance"])
    new_pos, new_vel, render_color, render_data = outs
    return state.replace(position=new_pos, velocity=new_vel,
                         render_color=render_color, render_data=render_data)


def block_plan(volume, substeps: int = 1) -> dict:
    """The block of a K4 launch on `volume` at `substeps`, on the current
    card: the instance, threads, shared memory, registers and spilled
    bytes a thread, resident blocks an SM."""
    plan = launch_plan(1, volume, substeps)
    out = (ctypes.c_int * 4)()
    LIBRARY.call("collide_integrate_plan", plan["instance"],
                 plan["smem_bytes"], out)
    kind = next(k for k, v in FIELD_KINDS.items() if v == plan["kind"])
    return dict(instance=f"{kind}/{substeps}", smem_bytes=plan["smem_bytes"],
                **dict(zip(("threads", "registers", "spill_bytes",
                            "blocks_per_sm"), out)))
