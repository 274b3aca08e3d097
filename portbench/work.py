"""The yardstick's arithmetic: the H100's published peaks, the least time a
piece of work can take on it (at the peak its operations run at), the
bytes and operations of each FL kernel call, and the least bytes of one FL
aggregation round.

A call's bytes are counted from the shapes and dtypes of its own tensor
arguments and results: every input byte read once and every output byte
written once, whatever the kernel reads again.  So a later change to an
operand's dtype changes the count with the work, and no share of a
roofline can pass 100%.  This generalises the byte and operation counts
of ``chip_smoke.py`` phase 14(a) (``kernel_work``) to each operand's own
dtype; its float32 figures are the special case.
"""

from __future__ import annotations

import re
from typing import NamedTuple, Sequence

#: NVIDIA H100 SXM data sheet: HBM3 bandwidth, float32 outside the tensor
#: cores, dense bf16 on the tensor cores (1,979e12 with sparsity), device
#: memory
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
HBM_BYTES = 80e9

#: the FL kernels' device names, as the profiler shows them
KERNELS = {
    "fedavg": re.compile(r"\bfedavg_\w+_kernel\b"),
    "quantize": re.compile(r"\bquantize_(?:lanes|wide)_kernel\b"),
    "dequantize": re.compile(r"\bdequantize_kernel\b"),
}


class Operand(NamedTuple):
    """A tensor's shape and bytes an element, as a call saw it."""
    shape: tuple
    itemsize: int

    @property
    def numel(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def nbytes(self) -> int:
        return self.numel * self.itemsize


def operand(t) -> Operand:
    """The :class:`Operand` of a tensor (anything with ``shape`` and
    ``element_size()``)."""
    return Operand(tuple(int(s) for s in t.shape), int(t.element_size()))


def bound_s(nbytes: int, flops: int, peak_flops: float = PEAK_F32_FLOPS
            ) -> tuple[float, str]:
    """The least seconds the card takes to move ``nbytes`` through device
    memory and do ``flops`` operations, and which of the two bounds it."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / peak_flops
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def call_bytes(args: Sequence[Operand], results: Sequence[Operand]) -> int:
    """Every tensor argument read once and every result written once."""
    return sum(a.nbytes for a in args) + sum(r.nbytes for r in results)


def fedavg_work(args, results) -> tuple[int, int]:
    """``fedavg(stack (K, N), weights (K,)) -> (N,)``: a multiply and an
    add a stacked value."""
    return call_bytes(args, results), 2 * args[0].numel


def quantize_work(args, results) -> tuple[int, int]:
    """``quantize(x (R, n), block) -> (codes, scales)``: an absmax step and
    a divide a value."""
    return call_bytes(args, results), 2 * args[0].numel


def dequantize_work(args, results) -> tuple[int, int]:
    """``dequantize(codes, scales, n, block) -> (R, n)``: a multiply an
    output value."""
    return call_bytes(args, results), results[0].numel


def params_per_pod(leaves: Sequence[Operand]) -> int:
    """Parameters a pod holds: the leaves' element counts."""
    return sum(leaf.numel for leaf in leaves)


def round_bytes(leaves: Sequence[Operand], pods: int) -> int:
    """The least bytes of one aggregation round over ``pods`` pods: the
    stacked input tree read once and the ``pods`` output copies written
    once, each in its leaf's own dtype (4 P N bytes for bf16 leaves)."""
    return sum(2 * pods * leaf.nbytes for leaf in leaves)
