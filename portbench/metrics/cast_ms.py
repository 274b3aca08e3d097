"""``cast_ms``: device milliseconds a round of the operations launched
inside the pod aggregation's ``fl_mesh.cast`` spans: each leaf's stacked
values cast to float32 (bf16 -> f32), pieces and all."""

from portbench import spans


def read(trace):
    return spans.span_device_ms(trace, "fl_mesh.cast")
