"""``agg_idle_ms``: device-idle milliseconds a round in the gaps that
begin while the host is inside a ``fl_mesh.aggregate`` span: the device
waiting on the program to issue its next operation, not on the harness
(the synchronize at a round's end, the next round's start)."""

from portbench import spans


def read(trace):
    found = spans.gaps(trace)
    if found is None or not trace.rounds:
        return None
    ns = sum(b - a for a, b, names in found if spans.AGGREGATE in names)
    return ns / 1e6 / trace.rounds
