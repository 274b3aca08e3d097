"""``agg_copy_ms``: device milliseconds a round in every operation other
than the three FL kernels (fedavg, quantize, dequantize): the casts to
and from float32, the fills and the broadcast copy of the pod
aggregation."""

from portbench import work


def read(trace):
    if not trace.rounds or not trace.device_ops:
        return None
    seconds, _ = trace.ops_s(exclude=tuple(work.KERNELS.values()))
    return seconds * 1e3 / trace.rounds
