"""K5's (the additive splat's) share of its roofline on the last traced
frame: the least time the H100 needs for the splat's work on that frame's
particles (bytes at the HBM peak or float32 operations at their peak,
whichever is larger; `_k5_work.py`) over the device time of that splat's
four kernels, read by name."""

from framebench.lib.peaks import bound_ms
from framebench.metrics._k5_work import splat_work

LAUNCHES_PER_SPLAT = 4
# The splat's kernels as the profiler names them, e.g.
# "(anonymous namespace)::bin_kernel((anonymous namespace)::Splat, ...)".
KERNELS = r"\b(bin|scan|scatter|accumulate)_kernel(<\d+>)?\(.*Splat"


def read(trace):
    if trace.peaks is None:
        return None
    ops = trace.ops_named(KERNELS)
    if len(ops) < LAUNCHES_PER_SPLAT:
        return None
    last = ops[-LAUNCHES_PER_SPLAT:]
    ms = sum(b - a for _, a, b in last) * 1e-3
    n_bytes, n_ops = splat_work(*trace.cell.splat_inputs())
    return 100.0 * bound_ms(trace.peaks, n_bytes, n_ops) / ms
