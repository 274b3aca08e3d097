"""Wrappers of the int8 quantize/dequantize kernels (the ``int8`` wire
stage's batch layout, with the block size as an argument).

On CUDA tensors they launch ``csrc/quantize.cu`` (bit-identical to the
host numpy codec); on CPU tensors they run the plain versions in
:mod:`repro_torch.kernels.quantize.ref`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.kernels import _build
from repro_torch.kernels.quantize import ref

_LIB = None
_MAX_CTAS = (1 << 31) - 1     # quantize runs one CTA per (row, block)
_MAX_DEQUANT_N = (1 << 31) - (1 << 24)  # dequantize's 32-bit columns


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("quantize")
        lib.quantize_f32_i8.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        lib.dequantize_i8_f32.argtypes = list(lib.quantize_f32_i8.argtypes)
        lib.quantize_f32_i8.restype = ctypes.c_int
        lib.dequantize_i8_f32.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check_device(t: torch.Tensor, what: str) -> None:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{what} runs on cuda or cpu, not {t.device}")
    if t.device.type == "cuda" and not t.is_contiguous():
        raise ValueError(f"{what} inputs must be contiguous")


def _check_block(block: int) -> int:
    block = int(block)
    if not 1 <= block < (1 << 31):
        raise ValueError(f"int8 block must be in [1, 2**31), got {block}")
    return block


def quantize(x: torch.Tensor, block: int
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (R, n) f32 -> (q (R, nb*block) int8, scales (R, nb) f32), with
    ``nb = ceil(n / block)``."""
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"quantize input must be a 2-D float32 tensor, "
                         f"got {tuple(x.shape)} {x.dtype}")
    block = _check_block(block)
    _check_device(x, "quantize")
    if x.device.type == "cpu":
        return ref.quantize(x, block)
    rows, n = x.shape
    nb = -(-n // block)
    if rows * nb > _MAX_CTAS:
        raise ValueError(f"quantize of {rows} rows x {nb} blocks exceeds "
                         f"one grid ({_MAX_CTAS} CTAs)")
    q = torch.empty((rows, nb * block), dtype=torch.int8, device=x.device)
    scales = torch.empty((rows, nb), dtype=torch.float32, device=x.device)
    if rows == 0 or nb == 0:
        return q, scales
    rc = _lib().quantize_f32_i8(
        x.data_ptr(), q.data_ptr(), scales.data_ptr(), rows, n, nb, block,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "quantize", "quantize_f32_i8")
    kernels.launch_counts["quantize"] += 1
    return q, scales


def dequantize(q: torch.Tensor, scales: torch.Tensor, n: int, block: int
               ) -> torch.Tensor:
    """q (R, nb*block) int8, scales (R, nb) f32 -> (R, n) f32."""
    block = _check_block(block)
    if scales.dim() != 2 or scales.dtype != torch.float32:
        raise ValueError(f"dequantize scales must be 2-D float32, got "
                         f"{tuple(scales.shape)} {scales.dtype}")
    rows, nb = scales.shape
    if q.dtype != torch.int8 or tuple(q.shape) != (rows, nb * block):
        raise ValueError(f"dequantize codes must be ({rows}, {nb * block}) "
                         f"int8, got {tuple(q.shape)} {q.dtype}")
    if not 0 <= n <= nb * block or (nb and n <= (nb - 1) * block):
        raise ValueError(f"n={n} does not fill {nb} blocks of {block}")
    if q.device != scales.device:
        raise ValueError(f"dequantize inputs on different devices: "
                         f"{q.device} and {scales.device}")
    _check_device(q, "dequantize")
    _check_device(scales, "dequantize")
    if q.device.type == "cpu":
        return ref.dequantize(q, scales, n, block)
    if nb * block >= 1 << 31 or n > _MAX_DEQUANT_N:
        raise ValueError(f"dequantize rows of {nb * block} codes exceed the "
                         f"kernel's 32-bit column indexing")
    out = torch.empty((rows, n), dtype=torch.float32, device=q.device)
    if rows == 0 or n == 0:
        return out
    rc = _lib().dequantize_i8_f32(
        q.data_ptr(), scales.data_ptr(), out.data_ptr(), rows, n, nb, block,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "quantize", "dequantize_i8_f32")
    kernels.launch_counts["dequantize"] += 1
    return out
