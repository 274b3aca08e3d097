"""``broadcast_ms``: device milliseconds a round of the operations
launched inside the pod aggregation's ``fl_mesh.broadcast`` spans: each
leaf's mean copied into every pod's own storage
(``expand(...).contiguous()``)."""

from portbench import spans


def read(trace):
    return spans.span_device_ms(trace, "fl_mesh.broadcast")
