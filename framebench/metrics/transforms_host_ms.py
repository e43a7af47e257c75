"""Host time a frame inside the program's `illuminant/particles/
transforms` span (the modifier chain's uniforms and its launch), on
frames run with the program's recorder on and no profiler
(`_recorded.py`)."""

from framebench.metrics._recorded import recorded

SPAN = "illuminant/particles/transforms"


def read(trace):
    rec = recorded(trace)
    return None if rec is None else rec.host_ms(SPAN)
