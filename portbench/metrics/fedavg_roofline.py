"""``fedavg_roofline``: the fedavg kernel's share of its roofline, in
percent: the least time of every captured ``fedavg`` wrapper call (its
tensor arguments read once and results written once, over 3.35 TB/s, or
its operations over the float32 peak, whichever is larger) over the
device time of its ``fedavg_*_kernel`` launches (every route) in the
window."""

from portbench import work

CALLS = ("repro_torch.kernels.fedavg.ops:fedavg",)


def read(trace):
    return trace.roofline_pct(CALLS[0], work.KERNELS["fedavg"],
                              work.fedavg_work)
