"""The particle tick's modifier chain on the card: the CUDA source
`csrc/modifiers.cu` (K4c), its wrapper, its uniform tables and its launch
plan.

K4c replaces, for CUDA tensors, the eager chain of `transforms.apply_*`
(`transforms.apply_modifiers_reference`, which `apply_modifiers` runs on
the CPU): about 500 small kernels
a tick of the config-4 system (VectorField, Gravity, Noise), 41 a flagship
frame (its Gravity), in one launch a step list, one thread a slot. The JAX
functions it is held to are `illuminant_tpu/particles/transforms.py`'s,
through the eager chain, which stays the plain version. The source's
header says what bounds it and how it keeps the eager chain's rounding.

A step list is a sequence of (eager function, uniforms) pairs, the
function one of `EAGER`'s (it names the step's kind). `takes` says whether
a call goes to the kernel: every call on the card. `program` reads a list's kinds and attractor
counts, `launch_plan` lays out the launches of such a program (pure: runs
on the CPU), `uniform_table` lists one step's uniform tensors in the
source's segment order, `modifiers_cuda` launches the kernel and
`block_plan` reports its block on the card. A launch's argument arrays are
made once per program and ring (kept on the SystemUniforms object, as
K4b's are kept on its uniforms); a call writes only the positions' and
velocities' pointers and those of the uniform tensors that changed since
the last call (a Noise's `frequency_lerp` and randomness offsets are
uploaded anew as time runs). The library is compiled from the
repository's source at first use (`core/cuda_build`).
"""

from __future__ import annotations

import ctypes
import operator

import torch

from ..core import cuda_build
from . import transforms as tx

LIBRARY = cuda_build.Library("modifiers.cu", {
    "k4c_modifiers": [ctypes.POINTER(ctypes.c_void_p),
                      ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p],
    "k4c_modifiers_plan": [ctypes.POINTER(ctypes.c_int)]},
    ["k4c_modifiers"])

THREADS = 256
# A launch's limits (the source's kMaxSteps, kMaxSegments, kMaxWords): a
# longer program runs as several launches of consecutive steps.
MAX_STEPS = 16
MAX_SEGMENTS = 192
MAX_WORDS = 2048

# The step kinds, in the source's Kind order, and the eager function that
# names each.
KINDS = ("fma", "matrix_multiply", "gravity", "vector_field", "noise",
         "spatial_noise")
EAGER = {tx.apply_fma: "fma", tx.apply_matrix_multiply: "matrix_multiply",
         tx.apply_gravity: "gravity", tx.apply_vector_field: "vector_field",
         tx.apply_noise: "noise", tx.apply_spatial_noise: "spatial_noise"}
# The kinds that sample a field: the VectorField its own, the noise the
# system's RandomField.
SAMPLED = ("vector_field", "noise", "spatial_noise")

# Each kind's uniform segments (the source's *Segment enums): a path into
# its uniforms and the 32-bit words the segment holds; Gravity's first
# five hold that many a attractor. "area.type" is int32, every other
# segment float32.
_AREA = (("area.type", 1), ("area.center", 3), ("area.size", 3),
         ("area.falloff", 1), ("area.rotation", 4), ("area.strength", 1))
_NOISE = _AREA + (
    ("position_offset", 4), ("position_minimum", 4), ("position_scale", 4),
    ("velocity_offset", 4), ("velocity_minimum", 4), ("velocity_scale", 4),
    ("replace_old_velocity", 1), ("cycles_per_second", 1),
    ("frequency_lerp", 1), ("randomness_offset", 2),
    ("next_randomness_offset", 2), ("space_scale", 2),
    ("category_filter", 2))
SEGMENTS = {
    "fma": _AREA + (("position_add", 4), ("position_multiply", 4),
                    ("velocity_add", 4), ("velocity_multiply", 4),
                    ("cycles_per_second", 1), ("category_filter", 2)),
    "matrix_multiply": _AREA + (("position_matrix", 16),
                                ("velocity_matrix", 16),
                                ("cycles_per_second", 1),
                                ("category_filter", 2)),
    "gravity": (("positions", 3), ("radiuses", 1), ("strengths", 1),
                ("falloff_types", 1), ("active", 1),
                ("maximum_acceleration", 1), ("category_filter", 2)),
    "vector_field": _AREA + (("field_scale", 2), ("field_offset", 2),
                             ("velocity_scale", 4),
                             ("replace_old_velocity", 1),
                             ("cycles_per_second", 1),
                             ("category_filter", 2)),
    "noise": _NOISE,
    "spatial_noise": _NOISE,
}
PER_ATTRACTOR = ("positions", "radiuses", "strengths", "falloff_types",
                 "active")
# A program's segment 0: SystemUniforms.global_settings (dt, friction,
# maximum_velocity, life_decay).
SYSTEM_WORDS = 4
# The pointers of a launch before each step's field and the segments, and
# each step's ints, in the source's order.
POINTERS = ("position", "velocity", "out_position", "out_velocity")
STEP_INTS = ("kind", "first", "attractors", "height", "width")
_GET = {kind: tuple(operator.attrgetter(name) for name, _ in segments)
        for kind, segments in SEGMENTS.items()}


def takes(device) -> bool:
    """True where `transforms.apply_modifiers` runs K4c: rows on a CUDA
    device (a step that is not one of `EAGER`'s functions raises there).
    The CPU runs the eager chain."""
    return torch.device(device).type == "cuda"


def program(steps) -> tuple:
    """A step list's program: each step's (kind, attractors), the
    attractors Gravity's padded count (0 for the other kinds)."""
    out = []
    for apply, u in steps:
        kind = EAGER.get(apply)
        if kind is None:
            raise ValueError(f"modifiers: no kernel step for {apply!r}")
        out.append((kind, int(u.radiuses.shape[0]) if kind == "gravity"
                    else 0))
    return tuple(out)


def segment_words(kind: str, attractors: int = 0) -> list:
    """The words of each of a step's segments."""
    return [size * (attractors if kind == "gravity"
                    and name in PER_ATTRACTOR else 1)
            for name, size in SEGMENTS[kind]]


def launch_plan(prog, n: int) -> dict:
    """Everything the launches of program `prog` over `n` slots are given
    but the tensors: `blocks` and `threads` of each launch, and its
    `chunks`, each a launch of consecutive steps within the source's
    limits: the steps (`start`, `stop`), each step's first segment
    (`firsts`) and each segment's first word in the block's copy and the
    copy's end (`offsets`; segment 0 the system's). Pure: runs on any
    device. Raises on a Gravity of more than 16 attractors and on a ring
    beyond int32 slots."""
    if n >= 2 ** 31:
        raise ValueError(f"modifiers: {n} slots leave int32")
    chunks = []
    for j, (kind, attractors) in enumerate(prog):
        if kind not in SEGMENTS:
            raise ValueError(f"modifiers: no kernel step of kind {kind!r}")
        if kind == "gravity" and not 1 <= attractors <= tx.MAX_ATTRACTORS:
            raise ValueError(f"modifiers: {attractors} attractors; at most "
                             f"{tx.MAX_ATTRACTORS} (Gravity.fx:3)")
        words = segment_words(kind, attractors)
        chunk = chunks[-1] if chunks else None
        if chunk is None or (j - chunk["start"] == MAX_STEPS
                             or len(chunk["offsets"]) + len(words)
                             > MAX_SEGMENTS + 1
                             or chunk["offsets"][-1] + sum(words)
                             > MAX_WORDS):
            chunk = dict(start=j, stop=j, firsts=[],
                         offsets=[0, SYSTEM_WORDS])
            chunks.append(chunk)
        chunk["stop"] = j + 1
        chunk["firsts"].append(len(chunk["offsets"]) - 1)
        for w in words:
            chunk["offsets"].append(chunk["offsets"][-1] + w)
    return dict(blocks=max(-(-n // THREADS), 1), threads=THREADS,
                chunks=chunks)


def uniform_table(kind: str, u) -> list:
    """A step's uniform tensors in SEGMENTS[kind] order, as `u` holds them
    (the launch reads them where they lie)."""
    return [get(u) for get in _GET[kind]]


def _segment(t, words: int, dtype, device):
    """`t` as the kernel reads it: contiguous, of `dtype`, `words` of them
    on `device` (a copy only where it is not)."""
    t = torch.as_tensor(t).to(device=device, dtype=dtype).contiguous()
    if t.numel() != words:
        raise ValueError(f"modifiers: a uniform of {t.numel()} values where "
                         f"the kernel reads {words}")
    return t


def _field(t, device):
    """A sampled field (H, W, 4) float32, contiguous and 16-byte aligned on
    `device` (a copy only where it is not)."""
    t = t.to(device=device, dtype=torch.float32).contiguous()
    if t.dim() != 3 or t.shape[2] != 4 or t.shape[0] < 1 or t.shape[1] < 1:
        raise ValueError(f"modifiers: a field of shape {tuple(t.shape)}, "
                         "not (H, W, 4)")
    return t if t.data_ptr() % 16 == 0 else t.clone()


class _Chunk:
    """One launch's argument arrays: `ptrs` (the rows, each step's field,
    each segment), `ints` (the slots, the counts, each step's ints, the
    offsets) and, for each field and segment slot, the tensor its pointer
    was last written from (`sources`) and the one it points to (`held`)."""

    def __init__(self, chunk, prog, n):
        self.start, self.stop = chunk["start"], chunk["stop"]
        self.kinds = [kind for kind, _ in prog[self.start:self.stop]]
        steps, offsets = self.stop - self.start, chunk["offsets"]
        segments = len(offsets) - 1
        self.ptrs = (ctypes.c_void_p * (len(POINTERS) + steps + segments))()
        step_ints = []
        for (kind, attractors), first in zip(prog[self.start:self.stop],
                                             chunk["firsts"]):
            step_ints += [KINDS.index(kind), first, attractors, 0, 0]
        self.ints = (ctypes.c_longlong * (3 + len(step_ints)
                                          + len(offsets)))(
            n, steps, segments, *step_ints, *offsets)
        self.words = [b - a for a, b in zip(offsets, offsets[1:])]
        self.types = [torch.float32]
        for kind in self.kinds:
            self.types += [torch.int32 if name == "area.type"
                           else torch.float32 for name, _ in SEGMENTS[kind]]
        self.sources = [None] * (steps + segments)
        self.held = [None] * (steps + segments)

    def bind(self, steps, su, random_field, device):
        """Write the pointers of the tensors that changed since the last
        call."""
        fields, segments = [], [su.global_settings]
        for kind, (_, u) in zip(self.kinds, steps[self.start:self.stop]):
            if kind == "vector_field":
                fields.append(u.field)
            elif kind in SAMPLED:
                if random_field is None:
                    raise ValueError("modifiers: a noise step without a "
                                     "RandomField")
                fields.append(random_field.data)
            else:
                fields.append(None)
            segments += uniform_table(kind, u)
        for j, t in enumerate(fields + segments):
            if t is self.sources[j]:
                continue
            slot = len(POINTERS) + j
            if j < len(fields):
                held = None if t is None else _field(t, device)
                base = 3 + len(STEP_INTS) * j
                self.ints[base + 3], self.ints[base + 4] = (
                    (0, 0) if held is None else held.shape[:2])
            else:
                s = j - len(fields)
                held = _segment(t, self.words[s], self.types[s], device)
            self.ptrs[slot] = None if held is None else held.data_ptr()
            self.sources[j], self.held[j] = t, held


def _launch(su, prog, n, device) -> list:
    """The program's launch arrays for this ring, one `_Chunk` a launch,
    made at the first call and kept on `su` (the last program's)."""
    key = (prog, n, device)
    kept = getattr(su, "_k4c_launch", None)
    if kept is not None and kept[0] == key:
        return kept[1]
    chunks = [_Chunk(c, prog, n) for c in launch_plan(prog, n)["chunks"]]
    object.__setattr__(su, "_k4c_launch", (key, chunks))
    return chunks


def modifiers_cuda(position, velocity, steps, su, random_field=None,
                   out=None):
    """The modifier chain of `steps` ((eager function, uniforms) pairs, in
    order) over the (N, 4) rows on the current stream: one K4c launch (a
    few for a list beyond one launch's limits) -> the new (position,
    velocity), written into `out` (two (N, 4) tensors) or into new
    tensors. `random_field` is the system's, which the noise steps
    sample. CUDA tensors only; reads nothing on the host."""
    dev = position.device
    if dev.type != "cuda" or not all(
            r.dtype == torch.float32 and r.is_contiguous()
            and r.dim() == 2 and r.shape[1] == 4
            and r.shape[0] == position.shape[0]
            and r.data_ptr() % 16 == 0 and r.device == dev
            for r in (position, velocity, *(out or ()))):
        raise ValueError("modifiers: the rows must be contiguous (N, 4) "
                         "float32 on one CUDA device")
    n = position.shape[0]
    chunks = _launch(su, program(steps), n, dev)
    out_p, out_v = out if out is not None else (torch.empty_like(position),
                                                torch.empty_like(velocity))
    src_p, src_v = position, velocity
    for chunk in chunks:
        chunk.bind(steps, su, random_field, dev)
        ptrs = chunk.ptrs
        for i, t in enumerate((src_p, src_v, out_p, out_v)):
            ptrs[i] = t.data_ptr()
        LIBRARY.launch("k4c_modifiers", "k4c_modifiers", dev, ptrs,
                       chunk.ints)
        src_p, src_v = out_p, out_v
    return out_p, out_v


def bytes_moved(prog, n: int) -> int:
    """Bytes the launches of `prog` over `n` slots have to move from device
    memory: each slot's position and velocity read and written once a
    launch (64 B), each launch's uniform words once. The fields' texels,
    which the L2 serves, are not counted."""
    chunks = launch_plan(prog, n)["chunks"]
    return 64 * n * len(chunks) + 4 * sum(c["offsets"][-1] for c in chunks)


def block_plan() -> dict:
    """The block of a K4c launch on the current card: threads, registers
    and local bytes (stack frame and spills) a thread, resident blocks an
    SM, static shared memory."""
    out = (ctypes.c_int * 5)()
    LIBRARY.call("k4c_modifiers_plan", out)
    return dict(zip(("threads", "registers", "local_bytes",
                     "blocks_per_sm", "smem_bytes"), out))
