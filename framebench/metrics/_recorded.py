"""The recorded stretch that the readers of host time without the profiler
read: frames of the cell run with the program's in-memory recorder on
(`illuminant_tpu_torch.core.trace.recording`), and no profiler.

The stretch runs once a traced run, at the first such reader, after the
window and every reader of the profiled frames: the cell runs
`LEAD_FRAMES` frames, then frames for at least `RECORD_S` seconds and
`MIN_FRAMES` frames with the recorder on, each inside the program span
`framebench/frame`, paced as the window paces them (before the host
starts frame i it waits for frame i - `IN_FLIGHT`). The recording is kept
on the trace (`trace.recorded`), and its top spans by host self time a
frame are printed on standard error.

A program without the recorder records nothing, and every such reader
reads None.
"""

from __future__ import annotations

import sys
import time

FRAME = "framebench/frame"
KERNEL = "illuminant/kernel/"
IN_FLIGHT = 2
LEAD_FRAMES = 4
RECORD_S = 3.0
MIN_FRAMES = 20
TABLE_ROWS = 15


class Recorded:
    """A recording of `frames` frames (its `framebench/frame` spans):
    `recorder` is the program's `trace.Recorder`, `names` its
    `by_name()`."""

    def __init__(self, recorder):
        self.recorder = recorder
        self.names = recorder.by_name()
        self.frames = self.names.get(FRAME, {}).get("calls", 0)

    def host_ms(self, name: str):
        """Host time a frame inside the span `name`, children included;
        None where no frame ran or the span never opened."""
        d = self.names.get(name)
        if not self.frames or d is None:
            return None
        return d["ns"] * 1e-6 / self.frames

    def syncs_per_frame(self):
        """Queue drains a frame inside the frames' spans."""
        if not self.frames:
            return None
        rec = self.recorder
        return (rec.totals["syncs"] - rec.outside["syncs"]) / self.frames

    def launch_host_us(self):
        """Mean host time of a hand-written kernel's launch span."""
        calls = ns = 0
        for name, d in self.names.items():
            if name.startswith(KERNEL):
                calls += d["calls"]
                ns += d["ns"]
        return ns * 1e-3 / calls if calls else None

    def table(self, rows: int = TABLE_ROWS) -> str:
        """The top `rows` spans by host self time a frame, with their host
        time, launches and syncs a frame."""
        f = self.frames
        lines = [f"recorded: {f} frames; frame_host_ms "
                 f"{self.host_ms(FRAME)}; syncs outside every span "
                 f"{self.recorder.outside['syncs']}",
                 f"{'span':<48} {'self_ms':>9} {'host_ms':>9} "
                 f"{'calls':>7} {'launches':>8} {'syncs':>6}   (a frame)"]
        top = sorted(self.names.items(), key=lambda kv: -kv[1]["self_ns"])
        for name, d in top[:rows]:
            lines.append(
                f"{name[:48]:<48} {d['self_ns'] * 1e-6 / f:9.4f} "
                f"{d['ns'] * 1e-6 / f:9.4f} {d['calls'] / f:7.2f} "
                f"{d['launches'] / f:8.2f} {d['syncs'] / f:6.2f}")
        return "\n".join(lines)


def record(cell, seconds: float = RECORD_S, min_frames: int = MIN_FRAMES,
           lead: int = LEAD_FRAMES):
    """The recorded stretch of `cell` -> a Recorded, or None where the
    program has no recorder."""
    import torch

    from framebench.lib.bench import _HostEvent

    try:
        from illuminant_tpu_torch.core import trace
    except ImportError:
        return None
    if not hasattr(trace, "recording"):
        return None
    cuda = getattr(cell, "device", None) is not None and \
        torch.device(cell.device).type == "cuda"
    events = [torch.cuda.Event() if cuda else _HostEvent()
              for _ in range(IN_FLIGHT)]
    frame = trace.span(FRAME)
    i = 0

    def paced():
        nonlocal i
        if i >= IN_FLIGHT:
            events[i % IN_FLIGHT].synchronize()
        with frame:
            cell.step()
        events[i % IN_FLIGHT].record()
        i += 1

    if cuda:
        torch.cuda.synchronize()
    for _ in range(lead):
        paced()
    with trace.recording() as rec:
        t0, n = time.perf_counter(), 0
        while n < min_frames or time.perf_counter() - t0 < seconds:
            paced()
            n += 1
    if cuda:
        torch.cuda.synchronize()
    return Recorded(rec)


def recorded(trace):
    """`trace.recorded`, the recorded stretch of the trace's cell, made at
    the first call (and its table printed); None without a cell or a
    recorder."""
    if not hasattr(trace, "recorded"):
        cell = getattr(trace, "cell", None)
        trace.recorded = None if cell is None else record(cell)
        if trace.recorded is not None:
            print(trace.recorded.table(), file=sys.stderr)
    return trace.recorded
