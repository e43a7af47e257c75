"""Device time a frame of the kernels launched inside the program's
`illuminant/renderer/field_regen` span: `LightingRenderer`'s budgeted
slabs (the eager distance evaluation K9 would replace), their writes into
copies of the partitions and the static / dynamic combine."""

SPAN = "illuminant/renderer/field_regen"


def read(trace):
    return trace.range_device_ms(SPAN)
