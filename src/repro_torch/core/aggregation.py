"""Model-parameter aggregation strategies.

The paper's Algorithm III / Eq. (1) is the sequential pairwise average
``new_i = (Client_i + Server_i) / 2`` applied per arriving client. That is
implemented faithfully (``pairwise_average``), alongside the principled
weighted FedAvg (McMahan et al., 2017) and a trimmed mean for robustness.

Pairwise, trimmed mean and :func:`fedavg` operate on parameter trees;
the orchestrator's FedAvg runs over the flat update stack it builds
(:func:`fedavg_stack`, and :func:`weighted_sum_stack` for the
delta-domain mean).  FedAvg runs on the hand-written fedavg kernel
(:mod:`repro_torch.kernels.fedavg`) by default; that kernel folds the
clients in the same order, with the same float32 rounding, as the numpy
path, so both backends give the same bits.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core.packetizer import (flatten_to_vector,
                                         tree_map as _tree_map,
                                         unflatten_from_vector)
from repro_torch.kernels.fedavg import ops as fedavg_ops

FEDAVG_BACKENDS = ("numpy", "kernel")


def pairwise_average(server_tree: Any, client_tree: Any) -> Any:
    """Paper Eq. (1): AggregatedParameters = (Client + Server) / 2.

    Order-dependent when folded over multiple clients — exactly as the paper
    applies it (per-transaction, as each client's packets complete).
    """
    return _tree_map(
        lambda s, c: (np.asarray(s, dtype=np.float32)
                      + np.asarray(c, dtype=np.float32)) / 2.0,
        server_tree, client_tree)


def fedavg(trees: Sequence[Any], weights: Optional[Sequence[float]] = None,
           backend: str = "kernel", *,
           device: _device.DeviceLike | None = None) -> Any:
    """Weighted FedAvg of parameter trees.  Weights default to uniform;
    normally |D_k|/|D|.

    ``"numpy"`` is the reference's per-leaf float32 fold (weights
    normalized as ``w / w.sum()``, then ``acc += w_i * leaf_i`` from zero
    in client order); ``"kernel"`` (the default) runs the same fold over
    the flattened trees through :func:`weighted_sum_stack`, on ``device``.
    Elementwise ops on a concatenation equal the ops on its slices, so the
    two give the same bits.  A kernel that cannot build raises.
    """
    if not trees:
        raise ValueError("fedavg of zero clients")
    if backend not in FEDAVG_BACKENDS:
        raise ValueError(f"unknown fedavg backend {backend!r}; "
                         f"one of {FEDAVG_BACKENDS}")
    if weights is None:
        weights = [1.0] * len(trees)
    w = np.asarray(weights, dtype=np.float32)
    w = w / w.sum()
    if backend == "kernel":
        stack = np.stack([flatten_to_vector(t) for t in trees])
        vec = weighted_sum_stack(stack, w, backend, device=device)
        return unflatten_from_vector(vec, _tree_map(
            lambda x: np.asarray(x, dtype=np.float32), trees[0]))

    def _avg(*leaves):
        acc = np.zeros_like(np.asarray(leaves[0], dtype=np.float32))
        for wi, leaf in zip(w, leaves):
            acc += wi * np.asarray(leaf, dtype=np.float32)
        return acc

    return _tree_map(_avg, *trees)


def fedavg_stack(stack: np.ndarray,
                 weights: Optional[Sequence[float]] = None,
                 backend: str = "kernel", *,
                 device: _device.DeviceLike | None = None) -> np.ndarray:
    """Weighted FedAvg over a flat update stack ``(K, P) -> (P,)``: the
    weights normalized on the host in float32 (``w / w.sum()``), then
    :func:`weighted_sum_stack`."""
    stack = np.asarray(stack, dtype=np.float32)
    if weights is None:
        weights = [1.0] * max(1, stack.shape[0])
    w = np.asarray(weights, dtype=np.float32)
    return weighted_sum_stack(stack, w / w.sum(), backend, device=device)


def weighted_sum_stack(stack: np.ndarray, weights: Sequence[float],
                       backend: str = "kernel", *,
                       device: _device.DeviceLike | None = None
                       ) -> np.ndarray:
    """``sum_k weights[k] * stack[k]`` over a flat update stack
    ``(K, P) -> (P,)``, folded in row order from zero as separate float32
    multiplies and adds.

    ``"numpy"`` accumulates ``acc += w_i * row_i`` on the host;
    ``"kernel"`` (the default) runs the same fold through
    :func:`repro_torch.kernels.fedavg.ops.fedavg` on ``device`` (the
    package default when None): the CUDA kernel on ``cuda``, its plain
    PyTorch version on ``cpu``.  Both give the same bits.
    """
    stack = np.asarray(stack, dtype=np.float32)
    if stack.ndim != 2 or stack.shape[0] == 0:
        raise ValueError(f"fedavg_stack needs a non-empty (K, P) stack, "
                         f"got shape {stack.shape}")
    if backend not in FEDAVG_BACKENDS:
        raise ValueError(f"unknown fedavg backend {backend!r}; "
                         f"one of {FEDAVG_BACKENDS}")
    w = np.asarray(weights, dtype=np.float32)
    if backend == "kernel":
        dev = _device.resolve(device)
        out = fedavg_ops.fedavg(
            torch.from_numpy(np.ascontiguousarray(stack)).to(dev),
            torch.from_numpy(w).to(dev))
        return out.cpu().numpy()
    acc = np.zeros(stack.shape[1], dtype=np.float32)
    for wi, row in zip(w, stack):
        acc += wi * row
    return acc


def trimmed_mean(trees: Sequence[Any], trim_fraction: float = 0.1) -> Any:
    """Coordinate-wise trimmed mean — robust to Byzantine/outlier clients."""
    k = int(len(trees) * trim_fraction)

    def _tm(*leaves):
        stack = np.stack([np.asarray(leaf, dtype=np.float32)
                          for leaf in leaves])
        stack.sort(axis=0)
        sl = stack[k:len(trees) - k] if len(trees) - 2 * k > 0 else stack
        return sl.mean(axis=0)

    return _tree_map(_tm, *trees)


def apply_delta(global_tree: Any, delta_tree: Any, server_lr: float = 1.0
                ) -> Any:
    """global + lr * delta (delta-transmission mode)."""
    return _tree_map(
        lambda g, d: np.asarray(g, dtype=np.float32)
        + server_lr * np.asarray(d, dtype=np.float32),
        global_tree, delta_tree)


def tree_sub(a: Any, b: Any) -> Any:
    return _tree_map(
        lambda x, y: np.asarray(x, dtype=np.float32)
        - np.asarray(y, dtype=np.float32), a, b)
