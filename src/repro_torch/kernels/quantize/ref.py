"""Plain PyTorch version of the blockwise int8 quantize/dequantize kernels.

Per block of ``block`` values (a row's tail block padded with zeros):
``s = max(absmax, 1e-12) / 127`` and ``q = clip(rint(x / s), -127, 127)``;
dequantize is ``q * s``.  Every operation is a correctly rounded float32
elementwise op or an exact max, so this matches the host numpy
``quantize_int8_batch`` / ``dequantize_int8_batch`` bit for bit.
"""

from __future__ import annotations

import torch


def quantize(x: torch.Tensor, block: int
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (R, n) f32 -> (q (R, nb*block) int8, scales (R, nb) f32)."""
    rows, n = x.shape
    nb = -(-n // block)
    padded = torch.zeros((rows, nb * block), dtype=torch.float32,
                         device=x.device)
    padded[:, :n] = x
    blocks = padded.view(rows, nb, block)
    absmax = blocks.abs().amax(dim=2)
    # Divide by a tensor, not the Python scalar 127.0: on CUDA PyTorch turns
    # division by a host scalar into a multiply by its reciprocal, which
    # is not correctly rounded.
    scales = torch.clamp_min(absmax, 1e-12) / torch.full_like(absmax, 127.0)
    q = torch.clamp(torch.round(blocks / scales[..., None]), -127, 127)
    return q.to(torch.int8).view(rows, nb * block), scales


def dequantize(q: torch.Tensor, scales: torch.Tensor, n: int, block: int
               ) -> torch.Tensor:
    """q (R, nb*block) int8, scales (R, nb) f32 -> (R, n) f32."""
    rows, nb = scales.shape
    out = q.view(rows, nb, block).to(torch.float32) * scales[..., None]
    return out.view(rows, nb * block)[:, :n].contiguous()
