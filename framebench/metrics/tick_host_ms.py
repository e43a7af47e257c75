"""Host time a frame inside the program's `illuminant/particles/tick`
span: the particle system's fixed steps (spawn, the transforms, the
integration with its column queries), as the host spends it launching
them."""

TICK = "illuminant/particles/tick"


def read(trace):
    return trace.range_host_ms(TICK)
