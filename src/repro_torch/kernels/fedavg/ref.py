"""Plain PyTorch version of the fedavg kernel.

Semantics: ``out = sum_k weights[k] * stack[k]`` over pre-normalized
weights, folded in client order as separate float32 multiplies and adds
(no fused multiply-add), exactly like the host numpy aggregation.
"""

from __future__ import annotations

import torch


def fedavg(stack: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """stack (K, N) float32, weights (K,) float32 -> (N,) float32."""
    acc = torch.zeros(stack.shape[1], dtype=torch.float32,
                      device=stack.device)
    for k in range(stack.shape[0]):
        acc = acc + weights[k] * stack[k]
    return acc
