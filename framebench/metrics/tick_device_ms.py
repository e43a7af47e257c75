"""Device time a frame of the kernels launched inside the program's
`illuminant/particles/tick` span, the hand-written ones (the column
query K7) attributed to it through their own `illuminant/kernel/*`
spans: no kernel is read by name."""

TICK = "illuminant/particles/tick"


def read(trace):
    return trace.range_device_ms(TICK)
