"""Wrappers of the top-k gather/scatter kernels (the ``topk`` wire stage's
value movement; index selection stays on the host).

On CUDA tensors they launch ``csrc/topk.cu``; on CPU tensors they run the
plain versions in :mod:`repro_torch.kernels.topk.ref`.  An index outside
its row raises :class:`IndexError` on either device: the kernels flag it
instead of touching memory out of bounds, and the wrapper reads the flag.

Each wrapper call launches one kernel and counts it in
:data:`repro_torch.kernels.launch_counts`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.kernels import _build
from repro_torch.kernels.topk import ref

_LIB = None
_MAX_INDEX = (1 << 31) - 1      # indices travel as int32


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("topk")
        lib.topk_gather_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.topk_scatter_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.topk_gather_f32.restype = ctypes.c_int
        lib.topk_scatter_f32.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check_idx(idx: torch.Tensor, rows: int, what: str) -> None:
    if idx.dim() != 2 or idx.dtype != torch.int32 or idx.shape[0] != rows:
        raise ValueError(f"{what} indices must be ({rows}, K) int32, got "
                         f"{tuple(idx.shape)} {idx.dtype}")


def _check_device(ts: tuple[torch.Tensor, ...], what: str) -> str:
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError(f"{what} inputs on different devices: "
                         f"{[str(t.device) for t in ts]}")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"{what} runs on cuda or cpu, not {dev}")
    if dev.type == "cuda" and not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{what} inputs must be contiguous")
    return dev.type


def _raise_if_flagged(err: torch.Tensor, what: str, bound: int) -> None:
    if int(err.item()):
        raise IndexError(f"{what}: an index lies outside [0, {bound})")


def _launch_gather(x: torch.Tensor, idx: torch.Tensor, out: torch.Tensor,
                   err: torch.Tensor) -> None:
    """Launch the gather kernel into ``out``; ``err`` ((1,) int32) is set
    to 1 on a bad index.  No checks and no read of ``err``, so no host
    sync: :func:`topk_gather` checks around it."""
    rows, p = x.shape
    rc = _lib().topk_gather_f32(
        x.data_ptr(), idx.data_ptr(), out.data_ptr(), rows, p,
        idx.shape[1], err.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "topk", "topk_gather_f32")
    kernels.launch_counts["topk_gather"] += 1


def _launch_scatter(idx: torch.Tensor, vals: torch.Tensor, out: torch.Tensor,
                    err: torch.Tensor) -> None:
    """Launch the scatter kernel into ``out`` (N, n), like
    :func:`_launch_gather`."""
    rows, k = idx.shape
    rc = _lib().topk_scatter_f32(
        idx.data_ptr(), vals.data_ptr(), out.data_ptr(), rows, k,
        out.shape[1], err.data_ptr(),
        torch.cuda.current_stream(idx.device).cuda_stream)
    _build.check(rc, "topk", "topk_scatter_f32")
    kernels.launch_counts["topk_scatter"] += 1


def topk_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (N, P) f32, idx (N, K) int32 -> (N, K) f32 values at idx."""
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"topk gather input must be a 2-D float32 tensor, "
                         f"got {tuple(x.shape)} {x.dtype}")
    _check_idx(idx, x.shape[0], "topk gather")
    rows, p = x.shape
    if _check_device((x, idx), "topk gather") == "cpu":
        if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= p):
            raise IndexError(f"topk gather: an index lies outside [0, {p})")
        return ref.gather(x, idx)
    out = torch.empty(idx.shape, dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    err = torch.empty(1, dtype=torch.int32, device=x.device)
    _launch_gather(x, idx, out, err)
    _raise_if_flagged(err, "topk gather", p)
    return out


def topk_scatter(idx: torch.Tensor, vals: torch.Tensor, n: int
                 ) -> torch.Tensor:
    """idx (N, K) int32, vals (N, K) f32 -> (N, n) f32: zeros, then
    ``vals`` at ``idx`` row by row, a duplicate index resolving last-wins."""
    if vals.dim() != 2 or vals.dtype != torch.float32:
        raise ValueError(f"topk scatter values must be a 2-D float32 "
                         f"tensor, got {tuple(vals.shape)} {vals.dtype}")
    _check_idx(idx, vals.shape[0], "topk scatter")
    if idx.shape != vals.shape:
        raise ValueError(f"topk scatter indices {tuple(idx.shape)} and "
                         f"values {tuple(vals.shape)} differ in shape")
    n = int(n)
    if not 0 <= n <= _MAX_INDEX:
        raise ValueError(f"topk scatter width must be in [0, 2**31), "
                         f"got {n}")
    rows, k = idx.shape
    if _check_device((idx, vals), "topk scatter") == "cpu":
        if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= n):
            raise IndexError(f"topk scatter: an index lies outside "
                             f"[0, {n})")
        return ref.scatter(idx, vals, n)
    out = torch.empty((rows, n), dtype=torch.float32, device=vals.device)
    if rows == 0:
        return out
    if n == 0:
        if k:
            raise IndexError("topk scatter: an index lies outside [0, 0)")
        return out
    err = torch.empty(1, dtype=torch.int32, device=vals.device)
    _launch_scatter(idx, vals, out, err)
    _raise_if_flagged(err, "topk scatter", n)
    return out
