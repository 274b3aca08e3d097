"""``agg_host_ms``: host milliseconds a round inside the
``fl_mesh.aggregate`` spans, one a call, outside the calls that put an
operation on the device and the profiler's ``Command Buffer Full``
records: the time the program's own Python and PyTorch's dispatch take to
issue its round.  Those are left out because, with rounds sent ahead, a
launch waits in them for room in CUDA's launch queue, which is the
device's pace and not the program's."""

import bisect

from portbench import spans

#: the profiler's record of a host blocked on a full launch queue
WAIT = "Command Buffer Full"


def read(trace):
    aggs = [op for op in spans.program_spans(trace)
            if op.name == spans.AGGREGATE]
    if not aggs or not trace.rounds:
        return None
    starts = [op.start_ns for op in aggs]
    ns = sum(op.end_ns - op.start_ns for op in aggs)
    t = 0  # the end of what was already left out (host_ops is sorted)
    for op in trace.host_ops:
        if not (spans.LAUNCH.match(op.name) or op.name == WAIT):
            continue
        k = bisect.bisect_right(starts, op.start_ns) - 1
        if k < 0 or op.start_ns >= aggs[k].end_ns:
            continue
        a, b = max(op.start_ns, t), min(op.end_ns, aggs[k].end_ns)
        if b > a:
            ns -= b - a
            t = b
    return ns / 1e6 / trace.rounds
