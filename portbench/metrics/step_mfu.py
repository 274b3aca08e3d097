"""``step_mfu``: the whole round's share of the card's peak, in percent.

The least time the card could take for one round (the step kind's own
count of its least bytes and operations, over the HBM bandwidth and over
the peak those operations run at, which the step kind names) over the
traced round time (the window over its rounds).  It counts only what the
round must do, whatever implements it, so it bounds every kernel's gain;
it reads a cell of any step kind.
"""

from portbench import work


def read(trace):
    nbytes, flops, peak_flops = trace.step.round_work()
    if not trace.rounds or trace.window_s <= 0:
        return None
    least = work.bound_s(nbytes, flops, peak_flops)[0]
    return 100.0 * least * trace.rounds / trace.window_s
