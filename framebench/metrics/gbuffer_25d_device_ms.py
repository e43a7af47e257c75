"""Device time a frame of the kernels launched inside the program's
`illuminant/renderer/gbuffer` span: `LightingRenderer`'s 2.5D G-buffer,
the ground plane, the height volumes' top and front faces and their
depth resolve (`gbuffer/height_volumes`, with the volumes' pack) and the
billboards (`gbuffer/billboards`), re-rasterized every frame."""

SPAN = "illuminant/renderer/gbuffer"


def read(trace):
    return trace.range_device_ms(SPAN)
