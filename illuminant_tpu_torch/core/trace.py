"""The port's one tracing mechanism: named spans of host time.

`span(name)` marks a stage of the program, as a context manager or as a
decorator — the counterpart of the JAX package's `jax.named_scope`.
While a profiler records (`torch.profiler.profile`, `emit_nvtx`), a span
opens a `torch.profiler.record_function` range, which lies on the
profiler's clock with the device operations; the profiler adds to its
device time that of the kernels launched inside it. While a recording
runs (`recording()`), a span appends one record to it: its name, its
parent (the innermost span open when it started), its start and end on
`time.perf_counter_ns()` and its counters. The two are independent. With
neither on, a span costs one check ahead of the profiler's and enters
nothing.

`launch(k)` is the span `illuminant/kernel/<k>` around one call into a
hand-written kernel's library (ctypes). The profiler attributes a kernel
to the innermost operator open when it was launched, and a
`record_function` range is no operator (its launches are tied only to
its device-side annotation). So a launch opens an operator's range (a
function-scope RecordFunction): the kernels it launches count in its
device time, and through it in every span around it, as an eager aten
operator's kernels do.

Counters (`count`), each added to the innermost open record and to the
recording's totals (to `outside` where no span is open):
  launches   kernels launched, added by `cuda_build.Library.launch`
             inside its launch span
  syncs      queue drains of any kind: while a recording runs with a
             CUDA card, torch's sync debug mode is "warn" and each
             synchronizing operation's warning is a count

Span names, "illuminant/<layer>/<stage>":
  illuminant/frame/*           the flagship frame's stages (`scenes.py`)
  illuminant/lighting/*, illuminant/scan_shadows, illuminant/sphere_lights,
  illuminant/tiled_particle_lights
                               the light families and the shadow scan
  illuminant/scan_shadows/readout
                               the scan's readout, from the column walk's
                               return to the visibility returned
  illuminant/sphere_lights/ao  the sphere lights' AO sample
  illuminant/renderer/*        `LightingRenderer`'s public calls, its
                               G-buffer (`gbuffer`, inside it
                               `gbuffer/height_volumes` and
                               `gbuffer/billboards`), its field
                               regeneration (`field_regen`, one
                               `field_slab` a slab written) and its light
                               passes
  illuminant/particles/*       `ParticleSystem.update`, `tick`, the
                               transforms, `render`
  illuminant/particle_spawn, illuminant/particle_integrate
                               the tick's spawn and integration
  illuminant/raster/*          `resolve`, `to_uint8`
  illuminant/kernel/*          one hand-written kernel's launch (`launch`)
"""

from __future__ import annotations

import contextlib
import functools
import time
import warnings

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import _profiler_enabled
from torch.profiler import record_function

COUNTERS = ("launches", "syncs")
# The warning torch's sync debug mode gives for a synchronizing operation.
SYNC_WARNING = "called a synchronizing CUDA operation"

# The running recording's Recorder, or None.
_RECORDER = None


class Record:
    """One span's record: `parent` is the index of the record of the
    innermost span open when it started (-1: none); times are
    `time.perf_counter_ns()`."""

    __slots__ = ("name", "parent", "start_ns", "end_ns") + COUNTERS

    def __init__(self, name: str, parent: int, start_ns: int):
        self.name, self.parent, self.start_ns = name, parent, start_ns
        self.end_ns = start_ns
        self.launches = self.syncs = 0

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns


class Recorder:
    """The records of one recording, in the order their spans started,
    with the counters' totals; `outside` holds what was counted while no
    span was open. `anchor` pairs `time.perf_counter_ns()` with
    `time.time_ns()` at the start, to put the records on a profiler's
    timeline (`profiler_us`)."""

    def __init__(self):
        self.records: list[Record] = []
        self.totals = dict.fromkeys(COUNTERS, 0)
        self.outside = dict.fromkeys(COUNTERS, 0)
        self.anchor = (0, 0)
        self._open: list[int] = []
        self._restore = None

    # -- while recording --------------------------------------------------

    def enter(self, name: str) -> int:
        i = len(self.records)
        self.records.append(Record(name, self._open[-1] if self._open
                                   else -1, time.perf_counter_ns()))
        self._open.append(i)
        return i

    def exit(self, i: int):
        now = time.perf_counter_ns()
        if self._open and self._open[-1] == i:
            self._open.pop()
        elif i in self._open:
            self._open.remove(i)
        else:  # ended by `stop`
            return
        self.records[i].end_ns = now

    def count(self, counter: str, n: int = 1):
        self.totals[counter] += n
        if self._open:
            rec = self.records[self._open[-1]]
            setattr(rec, counter, getattr(rec, counter) + n)
        else:
            self.outside[counter] += n

    def _on_warning(self, message, category, *args, **kwargs):
        if str(message).startswith(SYNC_WARNING):
            self.count("syncs")
        else:
            self._restore[1](message, category, *args, **kwargs)

    def start(self) -> "Recorder":
        """Make this recorder current. It counts each warning of torch's
        sync debug mode as a sync; where torch has set up a CUDA card,
        that mode is "warn" until `stop`."""
        global _RECORDER
        if _RECORDER is not None:
            raise RuntimeError("a recording is running already")
        caught = warnings.catch_warnings()
        caught.__enter__()
        mode = None
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
        self._restore = (caught, warnings.showwarning, mode)
        warnings.filterwarnings("always", message=SYNC_WARNING)
        warnings.showwarning = self._on_warning
        self.anchor = (time.perf_counter_ns(), time.time_ns())
        _RECORDER = self
        return self

    def stop(self) -> "Recorder":
        """End the recording: spans still open end now; the sync debug
        mode and the warning filters are restored."""
        global _RECORDER
        if _RECORDER is self:
            _RECORDER = None
        now = time.perf_counter_ns()
        for i in self._open:
            self.records[i].end_ns = now
        self._open = []
        if self._restore is not None:
            caught, _, mode = self._restore
            if mode is not None:
                torch.cuda.set_sync_debug_mode(mode)
            caught.__exit__(None, None, None)
            self._restore = None
        return self

    # -- readings ---------------------------------------------------------

    def self_ns(self) -> list[int]:
        """Each record's self time: its duration less the part of its
        interval that its child spans cover."""
        children: dict[int, list[Record]] = {}
        for r in self.records:
            if r.parent >= 0:
                children.setdefault(r.parent, []).append(r)
        out = []
        for i, r in enumerate(self.records):
            covered, reach = 0, r.start_ns
            for c in sorted(children.get(i, ()), key=lambda c: c.start_ns):
                a, b = max(c.start_ns, reach), min(c.end_ns, r.end_ns)
                if b > a:
                    covered += b - a
                    reach = b
            out.append(r.ns - covered)
        return out

    def by_name(self) -> dict:
        """name -> dict(calls, ns (the records of the name inside none of
        the same name, children included), self_ns, launches, syncs)."""
        out = {}
        for r, own in zip(self.records, self.self_ns()):
            d = out.setdefault(r.name, dict(calls=0, ns=0, self_ns=0,
                                             launches=0, syncs=0))
            d["calls"] += 1
            d["self_ns"] += own
            d["launches"] += r.launches
            d["syncs"] += r.syncs
            if not self._inside(r, r.name):
                d["ns"] += r.ns
        return out

    def _inside(self, r: Record, name: str) -> bool:
        while r.parent >= 0:
            r = self.records[r.parent]
            if r.name == name:
                return True
        return False

    def profiler_us(self, trace_start_ns: int, ns: int) -> float:
        """A `perf_counter_ns` time on a torch.profiler timeline: its
        events' times are microseconds of the wall clock from
        `trace_start_ns` (`prof.profiler.kineto_results.trace_start_ns()`)."""
        perf, wall = self.anchor
        return (wall + ns - perf - trace_start_ns) * 1e-3


@contextlib.contextmanager
def recording():
    """`with recording() as rec: ...` records every span the block opens
    into `rec`, a Recorder, stopped when the block ends."""
    rec = Recorder().start()
    try:
        yield rec
    finally:
        rec.stop()


def count(counter: str, n: int = 1):
    """Add `n` to `counter` ("launches" or "syncs") of the innermost open
    span of the running recording; nothing without one."""
    rec = _RECORDER
    if rec is not None:
        rec.count(counter, n)


class span:
    """A named span: `with span(name): ...` or `@span(name)`. A span
    object serves one `with` at a time; a decorated function opens a
    fresh range and record on every call."""

    __slots__ = ("name", "_active")

    def __init__(self, name: str):
        self.name = name
        self._active = None

    def _open(self):
        return record_function(self.name)

    def _range(self):
        rng = self._open()
        rng.__enter__()
        return rng

    def __enter__(self):
        rec = _RECORDER
        if rec is None:
            if _profiler_enabled():
                self._active = (None, -1, self._range())
            return self
        i = rec.enter(self.name)
        self._active = (rec, i, self._range() if _profiler_enabled()
                        else None)
        return self

    def __exit__(self, *exc):
        active = self._active
        if active is not None:
            self._active = None
            rec, i, rng = active
            if rng is not None:
                rng.__exit__(*exc)
            if rec is not None:
                rec.exit(i)
        return False

    def __call__(self, fn):
        name, kind = self.name, type(self)

        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if _RECORDER is None and not _profiler_enabled():
                return fn(*args, **kwargs)
            fresh = object.__new__(kind)
            fresh.name, fresh._active = name, None
            with fresh:
                return fn(*args, **kwargs)

        return inner


class launch(span):
    """The span `illuminant/kernel/<kernel>` around one library call that
    launches a hand-written kernel: `with launch("k5_splat"): ...`."""

    __slots__ = ()

    def __init__(self, kernel: str):
        super().__init__(f"illuminant/kernel/{kernel}")

    def _open(self):
        return _RecordFunctionFast(self.name)
