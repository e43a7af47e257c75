"""The particles' spawn on the card: the CUDA source `csrc/spawn.cu`
(K4b), its wrapper, its uniform table and its launch plan.

K4b replaces, for CUDA tensors, the eager body of `spawner.spawn`
(`spawner.spawn_reference`) and the eager evaluation of the spawn's
animated uniforms (`spawner.animated`: the emission path's
`evaluate_bezier`, a post-matrix's `evaluate_bezier_matrix`), about 800
small kernels a flagship frame: one launch a call, one thread a window
row, the animated uniforms evaluated in the launch from the time on the
device. The JAX function it is held to is
`illuminant_tpu/particles/spawner.py:spawn`, through the eager body, which
stays the plain version (CPU tensors, and `spawn_feedback`). The source's
header says what bounds it and how it keeps the eager body's rounding.

`takes` says whether a call goes to the kernel. `uniform_table` lists the
uniform tensors a launch reads, in the source's segment order, and
`SEGMENT_OFFSETS` lays out their copy in the block, which the launch
passes; `launch_plan` is pure and runs on the CPU; `spawn_cuda` launches the
kernel, and `block_plan` reports its block on the card. A launch's
argument arrays are made once per uniforms object and ring (kept on the
uniforms, as `columns_kernel.packed` keeps its pack on the field); a call
writes only its own pointers and values into them. The library is
compiled from the repository's source at first use (`core/cuda_build`).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core import cuda_build

LIBRARY = cuda_build.Library("spawn.cu", {
    "k4b_spawn": [ctypes.POINTER(ctypes.c_void_p),
                  ctypes.POINTER(ctypes.c_longlong),
                  ctypes.POINTER(ctypes.c_float), ctypes.c_void_p],
    "k4b_spawn_plan": [ctypes.POINTER(ctypes.c_int)]},
    ["k4b_spawn"])

THREADS = 256
# An animation (a BezierM) control's fields and their floats.
CONTROL_FIELDS = (("matrix", 16), ("angle", 1), ("scale", 1),
                  ("translation", 3), ("is_dynamic", 1))
ANIMATIONS = ("position_animation", "velocity_animation")
# The uniform table (the source's Segment enum): each segment's name, a
# path into SpawnUniforms ("head" is a bezier's range_and_count), and the
# floats its slot of the block's copy holds, in order. The layout lives
# here alone: a launch passes each slot's offset.
UNIFORM_SEGMENTS = (
    ("config", 36), ("formula_types", 4), ("position_matrix", 16),
    ("velocity_matrix", 16), ("axis_mask", 3),
    ("align_velocity_and_position", 1), ("attribute_discard_threshold", 1),
    ("polygon_rate", 1), ("polygon_loop", 1),
    ("position_constant_count", 1), ("position_path.head", 4),
    ("position_path.points", 12))
for _animation in ANIMATIONS:
    UNIFORM_SEGMENTS += ((f"{_animation}.head", 4),) + tuple(
        (f"{_animation}.{control}.{field}", floats)
        for control in "abcd" for field, floats in CONTROL_FIELDS)
SEGMENT_OFFSETS = tuple(int(v) for v in np.cumsum(
    [0] + [size for _, size in UNIFORM_SEGMENTS]))
UNIFORM_FLOATS = SEGMENT_OFFSETS[-1]
# The pointers of a launch before the uniform table, in the source's
# order; the count and the time are None where they are host values.
POINTERS = ("position", "velocity", "color", "write_cursor",
            "total_spawned", "out_cursor", "out_total", "random1",
            "random2", "random3", "count", "time", "position_constants",
            "position_colors")
# Its ints before each segment's floats and SEGMENT_OFFSETS, and its
# floats.
INTS = ("count", "spawn_max", "capacity", "ranks", "rank", "sub_rings",
        "first_segment", "segments", "position_constants", "path_constant")
FLOATS = ("time", "path_period", "position_period", "velocity_period")
_SLOT = {name: i for i, name in enumerate(POINTERS)}


def takes(device) -> bool:
    """True where `spawner.spawn` runs K4b: a state on a CUDA device. The
    CPU runs the eager body."""
    return torch.device(device).type == "cuda"


def launch_plan(capacity: int, spawn_max: int, sub_rings: int = 1,
                shard=None) -> dict:
    """Everything a K4b launch on a ring of `capacity` slots (a mesh
    rank's shard of `capacity` x ranks with `shard=(rank, ranks)`) is
    given but the tensors: `blocks`, `threads`, the sub-rings it writes
    (`first_segment`, `segments`: a rank's own with sub-rings, all
    otherwise; one, the whole ring, without sub-rings), the `lanes` of a
    segment (its slots that the window writes: its rows, or its slots
    where the rows overlap), the `ranks`, the `rank` and the whole
    `ring`'s slots. Pure: runs on any device.
    Raises on a ring beyond int32 slots."""
    rank, ranks = (0, 1) if shard is None else shard
    ring = capacity * ranks
    if ring >= 2 ** 31:
        raise ValueError(f"spawn: {ring} slots leave int32")
    first_segment, segments = 0, sub_rings
    if sub_rings > 1 and shard is not None:
        first_segment, segments = (rank * sub_rings // ranks,
                                   sub_rings // ranks)
    lanes = min(spawn_max // sub_rings, ring // sub_rings)
    return dict(blocks=max(-(-(segments * lanes) // THREADS), 1),
                threads=THREADS, first_segment=first_segment,
                segments=segments, lanes=lanes, ranks=ranks, rank=rank,
                ring=ring)


def _segment(u, name: str):
    obj = u
    for part in name.split("."):
        if obj is None:
            return None
        obj = obj.range_and_count if part == "head" else getattr(obj, part)
    return obj


def uniform_table(u) -> list:
    """The uniform tensors of a launch in UNIFORM_SEGMENTS order, each
    flattened float32 (no copy where it already is one), None where the
    uniforms have none (read as zeros): the path and each animation
    absent, a static post-matrix that an animation replaces. The path has
    3 channels; each post-matrix is static or animated."""
    for which in ("position", "velocity"):
        if (getattr(u, f"{which}_matrix") is None
                and getattr(u, f"{which}_animation") is None):
            raise ValueError(f"spawn: no {which} post-matrix")
    out = []
    for name, size in UNIFORM_SEGMENTS:
        t = _segment(u, name)
        if t is not None:
            t = torch.as_tensor(t).to(torch.float32).contiguous().reshape(-1)
            if t.numel() > size:
                raise ValueError(f"spawn: {name} holds {t.numel()} floats, "
                                 f"its segment {size}")
        out.append(t)
    return out


def _rows(t):
    """A contiguous float32 tensor, its data aligned for the kernel's
    16-byte loads."""
    t = t.to(torch.float32).contiguous()
    if t.data_ptr() % 16:
        t = t.clone()
    return t


class _Launch:
    """A launch's argument arrays for one uniforms object and ring: the
    uniforms' pointers, the ring's ints and the periods filled in; the
    slots of the state, the draws, the count and the time written by each
    call. `tensors` keeps what the pointers point to."""

    def __init__(self, u, capacity, spawn_max, sub_rings, shard, device):
        plan = launch_plan(capacity, spawn_max, sub_rings, shard)
        table = uniform_table(u)
        constants = _rows(u.position_constants)
        colors = (None if u.position_colors is None
                  else _rows(u.position_colors))
        if constants.dim() != 2 or constants.shape[1] != 4 or (
                colors is not None and colors.shape != constants.shape):
            raise ValueError("spawn: the position constants and colours "
                             "must be (P, 4)")
        self.tensors = [constants, colors] + table
        if any(t is not None and t.device != device for t in self.tensors):
            raise ValueError(f"spawn: no kernel for uniforms off {device}")
        self.ptrs = (ctypes.c_void_p * (len(POINTERS) + len(table)))()
        for i, t in enumerate(self.tensors):
            self.ptrs[_SLOT["position_constants"] + i] = (
                None if t is None else t.data_ptr())
        path = u.position_path
        self.ints = (ctypes.c_longlong * (len(INTS) + len(table)
                                          + len(SEGMENT_OFFSETS)))(
            0, spawn_max, capacity, plan["ranks"], plan["rank"], sub_rings,
            plan["first_segment"], plan["segments"], constants.shape[0],
            int(path is not None and bool(path.is_constant)),
            *(0 if t is None else t.numel() for t in table),
            *SEGMENT_OFFSETS)
        self.floats = (ctypes.c_float * len(FLOATS))(
            0.0, *(float(p) for p in u.animation_periods))


def _launch(u, capacity, spawn_max, sub_rings, shard, device) -> _Launch:
    """The uniforms' launch arrays for this ring, made at the first call
    and kept on `u` (the last ring's)."""
    key = (capacity, spawn_max, sub_rings, shard, device)
    kept = getattr(u, "_k4b_launch", None)
    if kept is not None and kept[0] == key:
        return kept[1]
    launch = _Launch(u, capacity, spawn_max, sub_rings, shard, device)
    object.__setattr__(u, "_k4b_launch", (key, launch))
    return launch


def spawn_cuda(state, u, count, spawn_max: int, draws, sub_rings: int = 1,
               shard=None, time=0.0):
    """One K4b launch on the current stream: the state after `spawn` with
    its arguments (see there), `draws` its three (spawn_max, 4) arrays on
    the state's device. Writes the window into the state's rows in place
    and returns the state with a new cursor and total. CUDA tensors only;
    the count and the time are host values or 0-d tensors on the device,
    which the launch reads there; the time may be None where the uniforms
    animate nothing."""
    dev = state.position.device
    if not all(r.dtype == torch.float32 and r.is_contiguous()
               and r.data_ptr() % 16 == 0 and r.device == dev
               for r in (state.position, state.velocity, state.color)):
        raise ValueError("spawn: the ring's rows must be contiguous float32 "
                         "on one CUDA device (they are written in place)")
    launch = _launch(u, state.capacity, spawn_max, sub_rings, shard, dev)
    ptrs, ints, floats = launch.ptrs, launch.ints, launch.floats
    draws = [_rows(d) for d in draws]
    if len(draws) != 3 or any(tuple(d.shape) != (spawn_max, 4)
                              or d.device != dev for d in draws):
        raise ValueError(f"spawn: the kernel takes three ({spawn_max}, 4) "
                         f"draws on {dev}")
    out_cursor = torch.empty((), dtype=torch.int32, device=dev)
    out_total = torch.empty((), dtype=torch.int32, device=dev)
    cursor, total = (t.to(device=dev, dtype=torch.int32)
                     for t in (state.write_cursor, state.total_spawned))
    for i, t in enumerate((state.position, state.velocity, state.color,
                           cursor, total, out_cursor, out_total, *draws)):
        ptrs[i] = t.data_ptr()
    if isinstance(count, torch.Tensor):
        count = count.to(device=dev, dtype=torch.int32)
        ptrs[_SLOT["count"]] = count.data_ptr()
    else:
        ptrs[_SLOT["count"]] = None
        ints[0] = int(count)
    if isinstance(time, torch.Tensor):
        time = time.to(device=dev, dtype=torch.float32)
        ptrs[_SLOT["time"]] = time.data_ptr()
    else:
        ptrs[_SLOT["time"]] = None
        floats[0] = 0.0 if time is None else float(time)
    LIBRARY.launch("k4b_spawn", "k4b_spawn", dev, ptrs, ints, floats)
    return state.replace(write_cursor=out_cursor, total_spawned=out_total)


def bytes_moved(u, rows: int, written: int) -> int:
    """Bytes a launch has to move: the uniform table's present floats,
    each position constant (and pattern colour) once, the three draws of
    each of the `rows` window rows it computes, the position, velocity and
    colour of each of the `written` rows it writes, and the cursor and
    total read and written."""
    table = sum(t.numel() for t in uniform_table(u) if t is not None)
    constants = u.position_constants.numel() * (
        1 if u.position_colors is None else 2)
    return 4 * (table + constants) + 48 * (rows + written) + 16


def block_plan() -> dict:
    """The block of a K4b launch on the current card: threads, registers
    and local bytes (stack frame and spills) a thread, resident blocks an
    SM, static shared memory."""
    out = (ctypes.c_int * 5)()
    LIBRARY.call("k4b_spawn_plan", out)
    return dict(zip(("threads", "registers", "local_bytes",
                     "blocks_per_sm", "smem_bytes"), out))
