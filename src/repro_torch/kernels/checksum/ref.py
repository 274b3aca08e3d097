"""Plain PyTorch version of the ChunkSum-32 checksum kernel.

Over byte values ``x_i``::

    A = sum_i x_i                       (mod 2**32)
    B = sum_i ((i mod 8191) + 1) * x_i  (mod 2**32)
    checksum = (A & 0xFFFF) | ((B & 0xFFFF) << 16)

Both sums are taken in int64 (exact for any buffer below 2**40 bytes) and
masked to 32 bits, which equals the definition's int32 wraparound.
"""

from __future__ import annotations

import torch

#: Weight period of ChunkSum-32 (the reference's checksum constant).
WEIGHT_PERIOD = 8191


def chunksum32(x: torch.Tensor) -> torch.Tensor:
    """x (L,) uint8 -> (2,) int32 holding the bits of ``A`` and ``B``."""
    xi = x.to(torch.int64)
    w = torch.arange(x.numel(), dtype=torch.int64,
                     device=x.device) % WEIGHT_PERIOD + 1
    sums = torch.stack([xi.sum(), (w * xi).sum()]) & 0xFFFFFFFF
    # Two's-complement view of the 32-bit values, as the kernel writes them.
    return torch.where(sums >= 1 << 31, sums - (1 << 32),
                       sums).to(torch.int32)


def combine(sums: torch.Tensor) -> int:
    """The checksum from :func:`chunksum32`'s ``(A, B)``."""
    a, b = (int(v) & 0xFFFFFFFF for v in sums.tolist())
    return (a & 0xFFFF) | ((b & 0xFFFF) << 16)
