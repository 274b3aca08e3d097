"""Plain reference of one FL aggregation round over a stacked pod axis, and
the comparison that judges a round's output against it.

A stacked leaf is (P, ...): P pods' copies of one parameter.  The round
gives every pod the aggregate:

* ``exact``: the float32 mean over the pods (each pod's values summed in
  pod order, then divided by P), cast back to the leaf's dtype;
* ``int8``: first each pod's rows (the leaf's last axis) go through the
  row-wise int8 round trip, ``scale = max(absmax, 1e-12) / 127``,
  ``q = clip(round_half_even(x / scale), -127, 127)``, ``q * scale``;
  then the mean as ``exact``.

Plain PyTorch only: this module imports nothing else, and works from the
input tree alone.  ``arith`` rounds every intermediate result through a
lower-precision dtype; that is the control, which the comparison has to
refuse.
"""

from __future__ import annotations

import torch

#: values a pod a block of rows, so a block's float32 temporaries stay
#: a few hundred MB beside the inputs and outputs
BLOCK_VALUES = 1 << 25
#: what a missing or misshapen output reads
WORST_GAP = 1e30


def _rounder(arith):
    if arith is None or arith == torch.float32:
        return lambda t: t
    return lambda t: t.to(arith).to(torch.float32)


def mean_rows(x: torch.Tensor, mode: str, arith=None) -> torch.Tensor:
    """``x`` (P, R, d), one block of rows of a stacked leaf -> the (R, d)
    float32 aggregate of the round, before the cast back."""
    if mode not in ("exact", "int8"):
        raise ValueError(mode)
    r = _rounder(arith)
    acc = None
    for k in range(x.shape[0]):
        v = r(x[k].to(torch.float32))
        if mode == "int8":
            absmax = v.abs().amax(dim=-1, keepdim=True)
            # a tensor divisor: division by a host scalar may become a
            # multiply by its reciprocal, which is not correctly rounded
            scale = r(torch.clamp_min(absmax, 1e-12)
                      / torch.full_like(absmax, 127.0))
            q = torch.clamp(torch.round(r(v / scale)), -127, 127)
            v = r(q * scale)
        acc = v if acc is None else r(acc + v)
    return r(acc / torch.full_like(acc, float(x.shape[0])))


def spacing(m: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The gap between neighbouring values of ``dtype`` at magnitude
    ``m`` (float32): ``eps * 2**floor(log2 m)``, at least the spacing at
    the smallest normal."""
    info = torch.finfo(dtype)
    _, exp = torch.frexp(torch.clamp_min(m, info.tiny))
    return torch.ldexp(torch.full_like(m, info.eps), exp - 1)


def _rows(t: torch.Tensor) -> torch.Tensor:
    """A stacked leaf as (P, R, d), d its last axis (1 for a 1-d stack)."""
    d = t.shape[-1] if t.dim() > 1 else 1
    return t.reshape(t.shape[0], -1, d)


def judge(inputs: dict, outputs: dict, mode: str, *, arith=None,
          block_values: int = BLOCK_VALUES) -> dict:
    """Hold every pod's copy of every output leaf against the reference
    computed from ``inputs`` (both ``name -> (P, ...)`` tensors).

    ``mismatch_share``: the share of output values not equal to the
    reference's.  ``max_gap_ulp``: the widest gap between an output value
    and the reference's, in units of the leaf dtype's spacing at the
    largest reference magnitude of its row (so values near zero read on
    their row's scale)."""
    missing = set(inputs) ^ set(outputs)
    if missing:
        return {"mismatch_share": 1.0, "max_gap_ulp": WORST_GAP}
    mism, worst, total = None, None, 0
    for name, x in inputs.items():
        out = outputs[name]
        if out.shape != x.shape or out.dtype != x.dtype:
            return {"mismatch_share": 1.0, "max_gap_ulp": WORST_GAP}
        xs, got_all = _rows(x), _rows(out)
        step = max(1, block_values // xs.shape[-1])
        for r0 in range(0, xs.shape[1], step):
            ref = mean_rows(xs[:, r0:r0 + step], mode, arith).to(x.dtype)
            got = got_all[:, r0:r0 + step]
            bad = (got != ref).sum()
            unit = spacing(ref.abs().amax(dim=-1).to(torch.float32), x.dtype)
            gap = ((got.to(torch.float32) - ref.to(torch.float32)).abs()
                   .amax(dim=-1) / unit).amax()
            gap = torch.nan_to_num(gap, nan=WORST_GAP, posinf=WORST_GAP)
            mism = bad if mism is None else mism + bad
            worst = gap if worst is None else torch.maximum(worst, gap)
        total += out.numel()
    if not total:
        return {"mismatch_share": 0.0, "max_gap_ulp": 0.0}
    return {"mismatch_share": float(mism) / total,
            "max_gap_ulp": min(float(worst), WORST_GAP)}


def aggregate(inputs: dict, mode: str, *, arith=None,
              block_values: int = BLOCK_VALUES) -> dict:
    """The whole round by the reference: ``name -> (P, ...)`` with every
    pod holding the aggregate.  With ``arith`` it is the control, put in
    the program's place."""
    out = {}
    for name, x in inputs.items():
        xs = _rows(x)
        res = torch.empty_like(xs)
        step = max(1, block_values // xs.shape[-1])
        for r0 in range(0, xs.shape[1], step):
            res[:, r0:r0 + step] = mean_rows(
                xs[:, r0:r0 + step], mode, arith).to(x.dtype)
        out[name] = res.view(x.shape)
    return out
