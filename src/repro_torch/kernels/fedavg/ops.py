"""Wrapper of the fedavg kernel: ``(K, N) f32, (K,) f32 -> (N,) f32``.

On a CUDA tensor it launches ``csrc/fedavg.cu`` (bit-identical to the
host numpy fold); on a CPU tensor it runs the plain version in
:mod:`repro_torch.kernels.fedavg.ref`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.kernels import _build
from repro_torch.kernels.fedavg import ref

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("fedavg")
        lib.fedavg_f32.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_longlong, ctypes.c_void_p]
        lib.fedavg_f32.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def fedavg(stack: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """``out[n] = sum_k weights[k] * stack[k, n]`` (weights already
    normalized), folded in client order."""
    if stack.dim() != 2 or stack.dtype != torch.float32:
        raise ValueError(f"fedavg stack must be a 2-D float32 tensor, got "
                         f"{tuple(stack.shape)} {stack.dtype}")
    if (weights.shape != (stack.shape[0],)
            or weights.dtype != torch.float32):
        raise ValueError(f"fedavg weights must be ({stack.shape[0]},) "
                         f"float32, got {tuple(weights.shape)} "
                         f"{weights.dtype}")
    if weights.device != stack.device:
        raise ValueError(f"fedavg inputs on different devices: "
                         f"{stack.device} and {weights.device}")
    if stack.device.type == "cpu":
        return ref.fedavg(stack, weights)
    if stack.device.type != "cuda":
        raise ValueError(f"fedavg runs on cuda or cpu, not {stack.device}")
    if not (stack.is_contiguous() and weights.is_contiguous()):
        raise ValueError("fedavg inputs must be contiguous")
    k, n = stack.shape
    out = torch.empty(n, dtype=torch.float32, device=stack.device)
    if n == 0:
        return out
    lib = _lib()
    rc = lib.fedavg_f32(stack.data_ptr(), weights.data_ptr(),
                        out.data_ptr(), k, n,
                        torch.cuda.current_stream(stack.device).cuda_stream)
    _build.check(rc, "fedavg", "fedavg_f32")
    kernels.launch_counts["fedavg"] += 1
    return out
