"""Host time a frame inside the benchmark's `framebench/frame` span, on
frames run with the program's recorder on and no profiler
(`_recorded.py`): how long the host takes to dispatch a frame. Against
`frame_ms`, the share of an untraced frame the host spends dispatching
it."""

from framebench.metrics._recorded import FRAME, recorded


def read(trace):
    rec = recorded(trace)
    return None if rec is None else rec.host_ms(FRAME)
