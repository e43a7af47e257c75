"""Host time a frame inside the lighting layer's range (the flagship's
`illuminant/frame/lighting`: the scan's column walk and the sphere
lights' shading)."""


def read(trace):
    name = trace.cell.ranges.get("lighting")
    return None if name is None else trace.range_host_ms(name)
