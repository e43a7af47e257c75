"""Host time a frame inside the program's `illuminant/renderer/
update_fields` span: the G-buffer, the obstructions' dirty flags
(`auto_invalidate`), the partitions' packs and the slabs' launches."""

SPAN = "illuminant/renderer/update_fields"


def read(trace):
    return trace.range_host_ms(SPAN)
