"""Device time a frame of the particle layer: the kernels launched inside
its range, plus its kernels launched through ctypes (which the profiler
does not attribute to a range), read by name."""


def read(trace):
    name = trace.cell.ranges.get("particles")
    if name is None:
        return None
    ms = trace.range_device_ms(name)
    if ms is None:
        return None
    pattern = trace.cell.kernels.get("particles")
    if pattern:
        ms += sum(b - a for _, a, b in trace.ops_named(pattern)) * 1e-3 \
            / trace.frames
    return ms
