"""``agg_host_ms``: host milliseconds a round inside the
``fl_mesh.aggregate`` spans, one a call: the time the program takes to
issue its round (the launches return before the device ends them)."""

from portbench import spans


def read(trace):
    aggs = [op for op in spans.program_spans(trace)
            if op.name == spans.AGGREGATE]
    if not aggs or not trace.rounds:
        return None
    return sum(op.end_ns - op.start_ns for op in aggs) / 1e6 / trace.rounds
