"""Wrappers of the int8 quantize/dequantize kernels (the ``int8`` wire
stage's batch layout, with the block size as an argument).

On CUDA tensors they launch ``csrc/quantize.cu`` (bit-identical to the
host numpy codec), quantize by the route :func:`quantize_plan` picks; on
CPU tensors they run the plain versions in
:mod:`repro_torch.kernels.quantize.ref`.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch import kernels
from repro_torch.kernels import _build
from repro_torch.kernels.quantize import ref

_LIB = None
_MAX_BLOCKS = (1 << 31) - 1   # quantize's blocks: 32-bit block indices
_MAX_DEQUANT_N = (1 << 31) - (1 << 24)  # dequantize's 32-bit columns
#: the H100's SMs, and the quantize CTAs (256 threads) an SM holds at most
SMS, CTAS_A_SM = 132, 8
QUANT_THREADS = 256
#: the threads the card holds at once: a call whose blocks, at one unit a
#: lane, need no more takes the short route
CARD_THREADS = SMS * CTAS_A_SM * QUANT_THREADS
#: blocks of at most NARROW_MAX values take a few lanes each (narrow), of
#: at most ROW_MAX a warp or a few (row), both from registers; longer
#: blocks a CTA each, read twice (wide)
NARROW_MAX, ROW_MAX = 128, 8192
#: float4 units a lane may hold on the row route (and, past one, short)
ROW_UNITS = (2, 4, 6, 8)
#: the (lanes, units) instantiations of ``quantize_lanes_kernel``: short,
#: then narrow, then row
QUANT_KERNELS = ((1, 1), (2, 1), (4, 1), (8, 1), (16, 1), (32, 1), (64, 1),
                 (128, 1), (256, 1), (256, 2), (256, 4), (256, 6), (256, 8),
                 (2, 2), (4, 2), (4, 4), (8, 4),
                 (32, 2), (32, 4), (32, 6), (32, 8), (64, 6), (64, 8),
                 (128, 6), (128, 8))


class QuantPlan(NamedTuple):
    route: str      # "short", "narrow", "row" or "wide"
    lanes: int      # threads a block
    units: int      # float4 units a lane holds (0: wide)
    per_cta: int    # blocks a CTA takes at a time
    grid: int       # CTAs
    vector: bool    # float4 loads (else each value alone)


def _fewest_units(lanes: int, block: int, units=ROW_UNITS) -> int:
    return next(u for u in units if 4 * u * lanes >= block)


def quantize_plan(rows: int, n: int, block: int, aligned: bool
                  ) -> QuantPlan:
    """The quantize kernel's geometry for ``rows`` rows of ``n`` values in
    blocks of ``block``; ``aligned``: :func:`is_aligned`'s condition.

    A unit is 4 values.  A call whose blocks all fit on the card at one
    unit a lane (up to 256 lanes a block, CARD_THREADS threads in all)
    takes the short route: that many lanes, so each thread's chain of
    divisions is as short as it gets (blocks over 1024 values: 256 lanes
    of the fewest units of ROW_UNITS).  Larger calls are paced by the
    bytes.  Narrow blocks (<= NARROW_MAX) hold 2^k units, rounded up,
    split as evenly as powers of two allow: 2^ceil(k/2) lanes of
    2^floor(k/2) units (16 values: 2 lanes of 2 units; 64: 4 of 4).  Row
    blocks (<= ROW_MAX) take one warp while 8 units a lane hold them,
    else 64, 128 or 256 lanes, with the fewest units of ROW_UNITS that
    hold the block (1024: 32 lanes of 8; 1600: 64 of 8; 5504: 256 of 6).
    A CTA takes QUANT_THREADS / lanes blocks at a time over a grid-stride
    loop, on at most the CTAs the SMs hold at once.  Longer blocks take a
    CTA each (wide)."""
    total = rows * -(-n // block)
    if block > ROW_MAX:
        return QuantPlan("wide", QUANT_THREADS, 0, 1, total, False)
    k = (-(-block // 4) - 1).bit_length()
    spread = min(QUANT_THREADS, 1 << k)
    if total * spread <= CARD_THREADS:
        route, lanes = "short", spread
        units = _fewest_units(lanes, block, (1,) + ROW_UNITS)
    elif block <= NARROW_MAX:
        route, lanes, units = "narrow", 1 << (k + 1) // 2, 1 << k // 2
    else:
        route = "row"
        lanes = next(g for g in (32, 64, 128, 256)
                     if block <= 4 * ROW_UNITS[-1] * g)
        units = _fewest_units(lanes, block)
    per = QUANT_THREADS // lanes
    return QuantPlan(route, lanes, units, per,
                     min(-(-total // per), SMS * CTAS_A_SM),
                     aligned and block % 4 == 0)


def is_aligned(x: torch.Tensor, block: int) -> bool:
    """Every block of a contiguous (R, n) f32 ``x`` starts on the 16-byte
    grid: its base does, and so do the block and (over several rows) the
    row strides."""
    rows, n = x.shape
    return (block % 4 == 0 and x.data_ptr() % 16 == 0
            and (rows <= 1 or n % 4 == 0))


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("quantize")
        lib.quantize_f32_i8.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_void_p]
        lib.dequantize_i8_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
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
    if rows * nb > _MAX_BLOCKS:
        raise ValueError(f"quantize of {rows} rows x {nb} blocks exceeds "
                         f"the kernel's {_MAX_BLOCKS} blocks")
    q = torch.empty((rows, nb * block), dtype=torch.int8, device=x.device)
    scales = torch.empty((rows, nb), dtype=torch.float32, device=x.device)
    if rows == 0 or nb == 0:
        return q, scales
    p = quantize_plan(rows, n, block, is_aligned(x, block))
    rc = _lib().quantize_f32_i8(
        x.data_ptr(), q.data_ptr(), scales.data_ptr(), rows, n, nb, block,
        p.lanes, p.units, p.grid, int(p.vector),
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
