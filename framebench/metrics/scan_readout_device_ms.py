"""Device time a frame of the kernels launched inside the program's
`illuminant/scan_shadows/readout` span: the scan's eager readout after
K1's column walk (the sector select, the nominated fields' upsample, the
exact refine's field evaluations, the compound-umbra guard and the
thresholds), K2's target."""

SPAN = "illuminant/scan_shadows/readout"


def read(trace):
    return trace.range_device_ms(SPAN)
