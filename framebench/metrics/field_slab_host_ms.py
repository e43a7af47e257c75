"""Host time a frame inside the program's `illuminant/renderer/
field_slab` spans (one a slab of the field written), on frames run with
the program's recorder on and no profiler (`_recorded.py`)."""

from framebench.metrics._recorded import recorded

SPAN = "illuminant/renderer/field_slab"


def read(trace):
    rec = recorded(trace)
    return None if rec is None else rec.host_ms(SPAN)
