"""Host time a frame inside the program's `illuminant/sphere_lights`
span, children included (the sphere lights' shading dispatch, with their
shadow and AO calls), on frames run with the program's recorder on and
no profiler (`_recorded.py`)."""

from framebench.metrics._recorded import recorded

SPAN = "illuminant/sphere_lights"


def read(trace):
    rec = recorded(trace)
    return None if rec is None else rec.host_ms(SPAN)
