"""Device time a frame of the kernels launched inside the program's
`illuminant/sphere_lights` span: the sphere lights' ray set-up, their
shadows (K12's march through its launch span, or the scan) and the eager
shading around them."""

SPAN = "illuminant/sphere_lights"


def read(trace):
    return trace.range_device_ms(SPAN)
