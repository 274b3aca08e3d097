"""Wrapper of the fedavg kernel: ``(K, N) f32, (K,) f32 -> (N,) f32``, or
with ``cast_to`` every row's copy of the mean in that dtype (the pod
route).

On a CUDA tensor it launches ``csrc/fedavg.cu`` (bit-identical to the
host numpy fold) by the route :func:`plan` picks, or the pod route laid
out by :func:`pod_plan`; on a CPU tensor it runs the plain version in
:mod:`repro_torch.kernels.fedavg.ref`.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from repro_torch import kernels
from repro_torch.kernels import _build
from repro_torch.kernels.fedavg import ref

_LIB = None
#: the H100's SMs: a route's grid covers them wherever N allows
SMS = 132
#: the wide route's CTAs (one thread a column), widest first
WIDE_TILES = (256, 128, 64, 32, 16, 8)
#: the tall routes' column strips a CTA, widest first
TALL_TILES = (128, 64, 32, 16, 8)
#: stacks of at most this many clients fold on the wide route: their
#: rows go straight from global memory to registers, one round trip
SHORT_K = 32
#: tall stacks of at most this many clients stream 4 KB stages (1024
#: floats, so the first lands sooner), taller ones 8 KB (half the turns)
SHORT_STAGE_K = 512
ROUTES = {"wide": 0, "tma": 1, "cp_async": 2}
#: the pod route's dtypes, by the code its launcher takes
POD_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: rows a pod-route thread loads before its first add, by kernel: the
#: fewest that hold the stack, at most the last (taller stacks in chunks)
POD_ROWS = (2, 4, 8, 32)


class Plan(NamedTuple):
    route: str      # "wide", "tma" or "cp_async"
    tile: int       # columns a CTA
    stage: int      # floats a shared-memory stage (tall routes; 0: wide)

    def blocks(self, n: int) -> int:
        return -(-n // self.tile)


def _widest(n: int, tiles: tuple[int, ...]) -> int:
    """The widest tile whose grid still covers the SMs, else the
    narrowest."""
    return next((t for t in tiles if -(-n // t) >= SMS), tiles[-1])


def plan(k: int, n: int, aligned: bool) -> Plan:
    """The kernel's route, columns a CTA and stage size for a (k, n)
    stack; ``aligned``: the stack's and the weights' bases and the stack's
    row stride (n * 4 bytes) lie on the 16-byte grid.

    Short stacks (k <= SHORT_K) and wide ones (256-column CTAs cover the
    SMs twice) take the wide route: one thread a column, rows loaded
    ahead in registers.  The rest take a tall route, whose CTAs stream a
    strip of ``tile`` columns through a ring of shared-memory stages: by
    TMA where it can address the rows, else by 4-byte ``cp.async``.  Every
    tile is the widest whose grid still covers the SMs.
    """
    if k <= SHORT_K or n >= 2 * SMS * WIDE_TILES[0]:
        return Plan("wide", _widest(n, WIDE_TILES), 0)
    tile = _widest(n, TALL_TILES)
    stage = 1024 if k <= SHORT_STAGE_K and tile <= 64 else 2048
    return Plan("tma" if aligned else "cp_async", tile, stage)


class PodPlan(NamedTuple):
    """Where the pod route's 16-byte vectors lie in each row."""
    head: int       # columns folded one a thread before the first vector
    vecs: int       # 16-byte vectors of columns a row, from ``head`` on
    rows: int       # rows loaded before a chunk's first add


def pod_plan(k: int, n: int, itemsize: int, base: int) -> PodPlan:
    """The pod route's layout of a contiguous (k, n) stack of ``itemsize``
    bytes a value at address ``base``: 16-byte vectors from the first
    column on the 16-byte grid, where every row's is (n a multiple of the
    vector), else every column alone."""
    v = 16 // itemsize
    head = -base % 16 // itemsize
    vecs = (n - head) // v if n % v == 0 else 0
    rows = next((r for r in POD_ROWS if k <= r), POD_ROWS[-1])
    return PodPlan(head if vecs else 0, vecs, rows)


def is_aligned(stack: torch.Tensor, weights: torch.Tensor) -> bool:
    """TMA's condition on a contiguous (K, N) f32 stack and its (K,)
    weights: both bases and the stack's row stride on the 16-byte grid."""
    return (stack.shape[1] % 4 == 0 and stack.data_ptr() % 16 == 0
            and weights.data_ptr() % 16 == 0)


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("fedavg")
        lib.fedavg_f32.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_longlong, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_int,
                                   ctypes.c_void_p]
        lib.fedavg_f32.restype = ctypes.c_int
        lib.fedavg_pods.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int,
                                    ctypes.c_longlong, ctypes.c_longlong,
                                    ctypes.c_longlong, ctypes.c_int,
                                    ctypes.c_void_p]
        lib.fedavg_pods.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def fedavg(stack: torch.Tensor, weights: torch.Tensor, *,
           cast_to: Optional[torch.dtype] = None) -> torch.Tensor:
    """``out[n] = sum_k weights[k] * stack[k, n]`` (weights already
    normalized), folded in client order.

    With ``cast_to`` (a dtype of :data:`POD_DTYPES`) the stack may be any
    of them too, its values widened to float32 exactly, and the result is
    a new (K, N) tensor in ``cast_to`` whose every row holds ``out``
    rounded to nearest even: one launch of the pod route in place of a
    cast, the fold, a cast back and a broadcast copy."""
    if cast_to is None:
        dtypes, names = (torch.float32,), "float32"
    else:
        dtypes, names = tuple(POD_DTYPES), "float32, bfloat16 or float16"
        if cast_to not in POD_DTYPES:
            raise ValueError(f"fedavg casts to {names}, not {cast_to}")
    if stack.dim() != 2 or stack.dtype not in dtypes:
        raise ValueError(f"fedavg stack must be a 2-D {names} tensor, got "
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
        return ref.fedavg(stack, weights, cast_to=cast_to)
    if stack.device.type != "cuda":
        raise ValueError(f"fedavg runs on cuda or cpu, not {stack.device}")
    if not (stack.is_contiguous() and weights.is_contiguous()):
        raise ValueError("fedavg inputs must be contiguous")
    if cast_to is not None:
        return _fedavg_pods(stack, weights, cast_to)
    k, n = stack.shape
    out = torch.empty(n, dtype=torch.float32, device=stack.device)
    if n == 0:
        return out
    p = plan(k, n, is_aligned(stack, weights))
    lib = _lib()
    rc = lib.fedavg_f32(stack.data_ptr(), weights.data_ptr(),
                        out.data_ptr(), k, n, ROUTES[p.route], p.tile,
                        p.stage,
                        torch.cuda.current_stream(stack.device).cuda_stream)
    _build.check(rc, "fedavg", "fedavg_f32")
    kernels.launch_counts["fedavg"] += 1
    return out


def _fedavg_pods(stack: torch.Tensor, weights: torch.Tensor,
                 cast_to: torch.dtype) -> torch.Tensor:
    """The pod route on a checked CUDA stack.  The result lies in a buffer
    one vector longer, placed so that its column ``head`` shares the
    stack's alignment."""
    k, n = stack.shape
    p = pod_plan(k, n, stack.element_size(), stack.data_ptr())
    v = 16 // stack.element_size()
    buf = torch.empty(k * n + v, dtype=cast_to, device=stack.device)
    skew = -(buf.data_ptr() // buf.element_size() + p.head) % v
    out = buf[skew:skew + k * n].view(k, n)
    if out.numel() == 0:
        return out
    rc = _lib().fedavg_pods(
        stack.data_ptr(), weights.data_ptr(), out.data_ptr(),
        POD_DTYPES[stack.dtype], POD_DTYPES[cast_to], k, n, p.head, p.vecs,
        p.rows, torch.cuda.current_stream(stack.device).cuda_stream)
    _build.check(rc, "fedavg", "fedavg_pods")
    kernels.launch_counts["fedavg"] += 1
    kernels.launch_counts["fedavg_pods"] += 1
    return out
