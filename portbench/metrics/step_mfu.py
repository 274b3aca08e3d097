"""``step_mfu``: the whole round's share of the card's peak, in percent.

The least time the card could take for one round (the step's own count
of its least bytes and operations over the published peaks) over the
traced round time (the window over its rounds).  It counts only what the
round must do, whatever implements it, so it bounds every kernel's gain.
"""

from portbench import work


def read(trace):
    nbytes, flops = trace.step.round_work()
    if not trace.rounds or trace.window_s <= 0:
        return None
    least = work.bound_s(nbytes, flops)[0]
    return 100.0 * least * trace.rounds / trace.window_s
