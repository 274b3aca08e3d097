"""``launches_per_round``: device operations (kernels, copies, fills) a
round, counted in the trace."""


def read(trace):
    if not trace.rounds or not trace.device_ops:
        return None
    return len(trace.device_ops) / trace.rounds
