"""Plain PyTorch version of the top-k gather/scatter kernels.

* gather: ``out[r, k] = x[r, idx[r, k]]`` (``torch.gather``).
* scatter: a zeros ``(N, n)`` tensor with ``vals[r, k]`` written at
  ``idx[r, k]`` for ``k = 0..K-1``, so a duplicate index within a row
  resolves last-wins, like the reference's sequential loop and numpy's
  fancy assignment.  PyTorch's ``index_put_`` leaves the winner among
  duplicates unspecified, so this version first finds, for every dense
  position, the largest ``k`` that writes it (``scatter_reduce_`` with
  ``amax``, which is exact in any order), and then gathers that ``k``'s
  value: the last write wins on any device, deterministically.

Indices must lie in ``[0, P)`` / ``[0, n)``; the wrappers check that.
"""

from __future__ import annotations

import torch


def gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (N, P) f32, idx (N, K) int -> (N, K) f32."""
    return torch.gather(x, 1, idx.long())


def scatter(idx: torch.Tensor, vals: torch.Tensor, n: int) -> torch.Tensor:
    """idx / vals (N, K) -> (N, n) f32, zeros off the kept set."""
    rows, k = idx.shape
    dev = vals.device
    if rows == 0 or k == 0 or n == 0:
        return torch.zeros((rows, n), dtype=torch.float32, device=dev)
    keys = (torch.arange(rows, device=dev).unsqueeze(1) * n
            + idx.long()).reshape(-1)
    order = torch.arange(rows * k, device=dev)
    winner = torch.full((rows * n,), -1, dtype=torch.int64, device=dev)
    winner.scatter_reduce_(0, keys, order, reduce="amax")
    picked = vals.reshape(-1).to(torch.float32)[winner.clamp_min(0)]
    return torch.where(winner >= 0, picked,
                       torch.zeros_like(picked)).view(rows, n)
