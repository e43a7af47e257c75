"""Device time a frame of the kernels launched inside the program's
`illuminant/renderer/render_lighting` span: the light packs, the sphere
lights' eager shading, K12's volume pack and march (held through their
launch spans) and the ambient."""

SPAN = "illuminant/renderer/render_lighting"


def read(trace):
    return trace.range_device_ms(SPAN)
