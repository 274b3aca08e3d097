"""``idle_share``: the share of the traced window, in percent, in which
no operation ran on the device."""


def read(trace):
    if trace.window_s <= 0 or not trace.device_ops:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
