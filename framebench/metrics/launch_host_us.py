"""Mean host time of one hand-written kernel's launch span
(`illuminant/kernel/<k>`: the wrapper's ctypes call, its checks and
counts), on frames run with the program's recorder on and no profiler
(`_recorded.py`)."""

from framebench.metrics._recorded import recorded


def read(trace):
    rec = recorded(trace)
    return None if rec is None else rec.launch_host_us()
