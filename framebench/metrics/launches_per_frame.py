"""Device operations (kernels, copies, fills) a frame: what the host
enqueues, each paid for by a launch on the host's critical path."""


def read(trace):
    if not trace.device_ops:
        return None
    return len(trace.device_ops) / trace.frames
