"""Device time a frame of the kernels launched inside the program's
particle raster stage, the K5 splat's included through its
`illuminant/kernel/k5_splat` span: `illuminant/frame/raster` in the
flagship frame, `illuminant/particles/render` around
`ParticleSystem.render`. The first of the two the trace holds is read."""

STAGES = ("illuminant/frame/raster", "illuminant/particles/render")


def read(trace):
    for name in STAGES:
        ms = trace.range_device_ms(name)
        if ms is not None:
            return ms
    return None
