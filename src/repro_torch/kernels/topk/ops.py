"""Wrappers of the top-k gather/scatter kernels (the ``topk`` wire stage's
value movement; index selection stays on the host).

On CUDA tensors they launch ``csrc/topk.cu``; on CPU tensors they run the
plain versions in :mod:`repro_torch.kernels.topk.ref`.  An index outside
its row raises :class:`IndexError` on either device: the kernels flag it
instead of touching memory out of bounds, and the wrapper reads the flag.
The gather's flag is never zeroed: each call stores its own stamp there
(:class:`StampedFlags`), so a call is one launch.

Each wrapper call launches one kernel and counts it in
:data:`repro_torch.kernels.launch_counts`.
"""

from __future__ import annotations

import ctypes
import itertools
import threading

import torch

from repro_torch import kernels
from repro_torch.kernels import _build
from repro_torch.kernels.topk import ref

_LIB = None
_MAX_INDEX = (1 << 31) - 1      # indices travel as int32
#: the scatter's column tiles: about one CTA an SM of the H100's 132
#: (SCATTER_TARGET_CTAS), in whole multiples of SCATTER_MIN_TILE columns
#: (a single short row still gets one CTA a 1024 columns), at most
#: SCATTER_MAX_TILE (one CTA's shared tile: 64 KB)
SCATTER_MIN_TILE, SCATTER_MAX_TILE = 1024, 16384
SCATTER_TARGET_CTAS = 132


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("topk")
        lib.topk_gather_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_ulonglong, ctypes.c_void_p, ctypes.c_void_p]
        lib.topk_scatter_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
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


class StampedFlags:
    """The gather's bad-index flags: one (1,) int64 tensor a key (the
    wrapper's key is (device, stream, host thread)), zero when made and
    never zeroed again, and the stamps of the calls, from one counter
    (1, 2, ...), so no two calls share one.  A bad call's kernel stores
    its stamp in its key's flag; :meth:`raised` is true only for the
    stamp the flag holds."""

    def __init__(self):
        self._flags: dict[tuple, torch.Tensor] = {}
        self._stamps = itertools.count(1)
        self._lock = threading.Lock()

    def flag(self, key: tuple, device) -> torch.Tensor:
        with self._lock:
            flag = self._flags.get(key)
            if flag is None:
                flag = self._flags[key] = torch.zeros(
                    1, dtype=torch.int64, device=device)
            return flag

    def stamp(self) -> int:
        with self._lock:
            return next(self._stamps)

    @staticmethod
    def raised(flag: torch.Tensor, stamp: int) -> bool:
        return int(flag.item()) == stamp


GATHER_FLAGS = StampedFlags()


def gather_flag(device) -> torch.Tensor:
    """The gather's flag for the current stream of ``device`` and this
    host thread."""
    stream = torch.cuda.current_stream(device)
    return GATHER_FLAGS.flag(
        (stream.device_index, stream.cuda_stream, threading.get_ident()),
        device)


def _launch_gather(x: torch.Tensor, idx: torch.Tensor, out: torch.Tensor,
                   flag: torch.Tensor, stamp: int) -> None:
    """Launch the gather kernel into ``out``; a bad index stores ``stamp``
    in ``flag`` ((1,) int64).  No checks and no read of ``flag``, so no
    host sync: :func:`topk_gather` checks around it."""
    rows, p = x.shape
    rc = _lib().topk_gather_f32(
        x.data_ptr(), idx.data_ptr(), out.data_ptr(), rows, p,
        idx.shape[1], stamp, flag.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "topk", "topk_gather_f32")
    kernels.launch_counts["topk_gather"] += 1


def scatter_tile(rows: int, n: int) -> int:
    """Columns of a row that one scatter CTA owns: the multiple of
    SCATTER_MIN_TILE that makes about SCATTER_TARGET_CTAS CTAs, at most
    SCATTER_MAX_TILE, and no wider than the row (rounded up to 4)."""
    want = -(-rows * n // SCATTER_TARGET_CTAS)
    tile = -(-max(want, 1) // SCATTER_MIN_TILE) * SCATTER_MIN_TILE
    return min(SCATTER_MAX_TILE, tile, -(-max(n, 1) // 4) * 4)


def scatter_scratch(rows: int, device) -> torch.Tensor:
    """The scatter's scratch, which the launch zeroes: the bad-index flag
    (element 0), a pad, then one 64-bit ticket a row."""
    return torch.empty(2 + 2 * rows, dtype=torch.int32, device=device)


def _launch_scatter(idx: torch.Tensor, vals: torch.Tensor, out: torch.Tensor,
                    scratch: torch.Tensor) -> None:
    """Launch the scatter kernel into ``out`` (N, n), like
    :func:`_launch_gather`; ``scratch`` is :func:`scatter_scratch`'s, and
    its element 0 is the bad-index flag."""
    rows, k = idx.shape
    n = out.shape[1]
    rc = _lib().topk_scatter_f32(
        idx.data_ptr(), vals.data_ptr(), out.data_ptr(), rows, k, n,
        scatter_tile(rows, n), scratch.data_ptr(),
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
    flag, stamp = gather_flag(x.device), GATHER_FLAGS.stamp()
    _launch_gather(x, idx, out, flag, stamp)
    if GATHER_FLAGS.raised(flag, stamp):
        raise IndexError(f"topk gather: an index lies outside [0, {p})")
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
    if k > _MAX_INDEX:
        raise ValueError(f"topk scatter keeps at most 2**31 - 1 entries a "
                         f"row, got {k}")
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
    scratch = scatter_scratch(rows, vals.device)
    _launch_scatter(idx, vals, out, scratch)
    _raise_if_flagged(scratch[:1], "topk scatter", n)
    return out
