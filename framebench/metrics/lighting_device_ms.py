"""Device time a frame of the kernels launched inside the lighting
layer's range."""


def read(trace):
    name = trace.cell.ranges.get("lighting")
    return None if name is None else trace.range_device_ms(name)
