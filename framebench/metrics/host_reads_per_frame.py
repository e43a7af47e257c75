"""Device-to-host reads of a scalar a frame (`aten::_local_scalar_dense`):
each waits for the device to drain its queue (the exposure's percentile
in the flagship)."""


def read(trace):
    if not trace.device_ops:
        return None
    return trace.host_counts.get("aten::_local_scalar_dense", 0) \
        / trace.frames
