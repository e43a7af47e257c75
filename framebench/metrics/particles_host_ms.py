"""Host time a frame inside the particle layer's range: the program's
`illuminant/frame/particles` in the flagship, the benchmark's own range
around `ParticleSystem.update` where the program has none."""


def read(trace):
    name = trace.cell.ranges.get("particles")
    return None if name is None else trace.range_host_ms(name)
