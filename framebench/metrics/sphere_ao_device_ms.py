"""Device time a frame of the kernels launched inside the program's
`illuminant/sphere_lights/ao` span: the sphere lights' AO sample, one
field evaluation above the surface for every light of a pass that holds
a light with an AO radius, and its squared ramp."""

SPAN = "illuminant/sphere_lights/ao"


def read(trace):
    return trace.range_device_ms(SPAN)
