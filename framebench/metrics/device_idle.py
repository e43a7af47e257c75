"""The share of the traced frames' wall time in which no device operation
ran: 1 - the union of the device operations' intervals over the stretch
from the first traced frame's start to the end of its last work, both
from the same trace."""


def read(trace):
    if not trace.device_ops or trace.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
