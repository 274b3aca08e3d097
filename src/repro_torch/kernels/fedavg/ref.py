"""Plain PyTorch version of the fedavg kernel.

Semantics: ``out = sum_k weights[k] * stack[k]`` over pre-normalized
weights, folded in client order as separate float32 multiplies and adds
(no fused multiply-add), exactly like the host numpy aggregation.  With
``cast_to`` (the pod route) the stack's values are widened to float32
first and every row of the result is the sum cast to ``cast_to``: the
cast, fold, cast back and broadcast the kernel's one launch replaces.
"""

from __future__ import annotations

from typing import Optional

import torch


def fedavg(stack: torch.Tensor, weights: torch.Tensor,
           cast_to: Optional[torch.dtype] = None) -> torch.Tensor:
    """stack (K, N) float32, weights (K,) float32 -> (N,) float32; with
    ``cast_to``, stack (K, N) of any float dtype -> (K, N) ``cast_to``."""
    acc = torch.zeros(stack.shape[1], dtype=torch.float32,
                      device=stack.device)
    for k in range(stack.shape[0]):
        acc = acc + weights[k] * stack[k].to(torch.float32)
    if cast_to is None:
        return acc
    return acc.to(cast_to).expand(stack.shape).contiguous()
