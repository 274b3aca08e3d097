"""``dequantize_roofline``: the dequantize kernel's share of its roofline, in
percent: the least time of every captured ``dequantize`` wrapper call (its
tensor arguments read once and results written once, over 3.35 TB/s, or
its operations over the float32 peak, whichever is larger) over the
device time of its ``dequantize_kernel`` launches in the window."""

from portbench import work

CALLS = ("repro_torch.kernels.quantize.ops:dequantize",)


def read(trace):
    return trace.roofline_pct(CALLS[0], work.KERNELS["dequantize"],
                              work.dequantize_work)
