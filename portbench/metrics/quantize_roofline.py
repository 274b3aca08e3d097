"""``quantize_roofline``: the quantize kernel's share of its roofline, in
percent: the least time of every captured ``quantize`` wrapper call (its
tensor arguments read once and results written once, over 3.35 TB/s, or
its operations over the float32 peak, whichever is larger) over the
device time of its ``quantize_lanes_kernel`` and ``quantize_wide_kernel``
launches in the window."""

from portbench import work

CALLS = ("repro_torch.kernels.quantize.ops:quantize",)


def read(trace):
    return trace.roofline_pct(CALLS[0], work.KERNELS["quantize"],
                              work.quantize_work)
