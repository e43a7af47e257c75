"""K12's (the cone march's) share of its roofline through the renderer's
voxel volume on the last traced frame: the least time the H100 needs for
the march's work on that frame's rays (bytes at the HBM peak or float32
operations at their peak, whichever is larger; `_k12_volume_work.py`,
counted with the plain reference's march and trilinear sample) over the
device time of that frame's `illuminant/kernel/k12_cone_trace` span,
which holds K12's kernel."""

from framebench.lib.peaks import bound_ms
from framebench.metrics._k12_volume_work import march_work

SPAN = "illuminant/kernel/k12_cone_trace"


def read(trace):
    traced = getattr(trace.cell, "traced_march", None)
    if trace.peaks is None or traced is None or not trace.device_ops:
        return None
    spans = sorted((a, d) for n, a, _, d in trace.ranges if n == SPAN)
    if not spans or spans[-1][1] <= 0.0:
        return None
    rays = traced()
    if rays is None:
        return None
    field, kw = rays
    n_bytes, n_ops = march_work(field, **kw)
    return 100.0 * bound_ms(trace.peaks, n_bytes, n_ops) \
        / (spans[-1][1] * 1e-3)
