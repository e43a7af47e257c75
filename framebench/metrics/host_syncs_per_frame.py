"""Queue drains a frame, of every kind (a scalar read, a blocking upload,
a copy to the host, a wait on the device), each counted on the program's
span it ran in while the program's recorder runs with torch's sync debug
mode at "warn" (`_recorded.py`)."""

from framebench.metrics._recorded import recorded


def read(trace):
    rec = recorded(trace)
    return None if rec is None else rec.syncs_per_frame()
