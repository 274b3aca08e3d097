"""``cast_back_ms``: device milliseconds a round of the operations
launched inside the pod aggregation's ``fl_mesh.cast_back`` spans: each
leaf's float32 mean cast back to the leaf's dtype (f32 -> bf16)."""

from portbench import spans


def read(trace):
    return spans.span_device_ms(trace, "fl_mesh.cast_back")
