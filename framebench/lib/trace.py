"""The reduction of a torch.profiler trace of a few steady frames to what
the per-layer metric readers read.

Device operations are the trace's device events (kernels, copies, fills),
less the device-side twins of the host ranges (record_function), which
span the timeline and are no work. A host range's device time is the time
of the kernels launched from inside it, as the profiler attributes them
through their launch calls; kernels launched through ctypes are not
attributed to a range and are read by name. Times are the trace's
microseconds, one clock for host and device.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional

# Host ranges of the program and of the benchmark: the names the metric
# readers select by, and whose device-side twins are not device work.
RANGE_PREFIXES = ("illuminant/", "framebench/")
FRAME_RANGE = "framebench/frame"


@dataclasses.dataclass
class Trace:
    frames: int
    # (name, start_us, end_us) of every device operation, in start order.
    device_ops: list
    # (name, start_us, end_us, device_us) of every host range.
    ranges: list
    # Host operation name -> count (aten::_local_scalar_dense: a read).
    host_counts: dict
    # The stretch of the trace the frames cover: the first frame range's
    # start to the end of the last device operation or frame range.
    start_us: float
    end_us: float
    # The cell, for readers that count a kernel's work on its inputs.
    cell: object = None
    peaks: Optional[dict] = None

    @property
    def window_s(self) -> float:
        return (self.end_us - self.start_us) * 1e-6

    def busy_intervals(self):
        """The union of the device operations' intervals, clipped to the
        stretch, as sorted disjoint (start, end) pairs."""
        spans = sorted((max(a, self.start_us), min(b, self.end_us))
                       for _, a, b in self.device_ops)
        out = []
        for a, b in spans:
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def range_host_ms(self, name: str) -> Optional[float]:
        spans = [(a, b) for n, a, b, _ in self.ranges if n == name]
        if not spans:
            return None
        return sum(b - a for a, b in spans) * 1e-3 / self.frames

    def range_device_ms(self, name: str) -> Optional[float]:
        """None where the trace holds no device work at all (a run off
        the card) or no such range."""
        spans = [d for n, _, _, d in self.ranges if n == name]
        if not spans or not self.device_ops:
            return None
        return sum(spans) * 1e-3 / self.frames

    def ops_named(self, pattern: str):
        """The device operations whose name matches `pattern` (a regular
        expression searched in the name)."""
        rx = re.compile(pattern)
        return [op for op in self.device_ops if rx.search(op[0])]

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, summed by name, and
        the idle gaps between device work summed by the innermost host
        range open at each gap's middle ("no range" outside them), in
        seconds over the stretch."""
        by_op = {}
        for name, a, b in self.device_ops:
            by_op[name[:200]] = by_op.get(name[:200], 0.0) + (b - a) * 1e-6
        gaps, t = {}, self.start_us
        busy = self.busy_intervals() + [[self.end_us, self.end_us]]
        for a, b in busy:
            if a > t:
                mid = 0.5 * (t + a)
                open_ = [(e - s, n) for n, s, e, _ in self.ranges
                         if s <= mid <= e and n != FRAME_RANGE]
                label = min(open_)[1] if open_ else "no range"
                gaps[label] = gaps.get(label, 0.0) + (a - t) * 1e-6
            t = max(t, b)

        def best(d):
            return [[k, v] for k, v in sorted(d.items(),
                                              key=lambda kv: -kv[1])[:top]]

        return dict(device_ops=best(by_op), idle_gaps=best(gaps))


def _device_us(event) -> float:
    for attr in ("device_time_total", "cuda_time_total"):
        value = getattr(event, attr, None)
        if value is not None:
            return float(value)
    return 0.0


def reduce(prof, frames: int, cell=None, peaks=None) -> Trace:
    """A Trace of `frames` frames from a finished torch.profiler.profile
    whose frames each ran inside a FRAME_RANGE range."""
    from torch.autograd import DeviceType

    device_ops, ranges, counts = [], [], {}
    for e in prof.events():
        name = e.name
        a, b = float(e.time_range.start), float(e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            if not name.startswith(RANGE_PREFIXES):
                device_ops.append((name, a, b))
        elif name.startswith(RANGE_PREFIXES):
            ranges.append((name, a, b, _device_us(e)))
        else:
            counts[name] = counts.get(name, 0) + 1
    device_ops.sort(key=lambda op: op[1])
    marks = [(a, b) for n, a, b, _ in ranges if n == FRAME_RANGE]
    if not marks:
        raise RuntimeError("the trace holds no frame range")
    start = min(a for a, _ in marks)
    end = max([b for _, b in marks] + [b for _, _, b in device_ops])
    return Trace(frames=frames, device_ops=device_ops, ranges=ranges,
                 host_counts=counts, start_us=start, end_us=end, cell=cell,
                 peaks=peaks)
