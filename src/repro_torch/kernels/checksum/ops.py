"""Wrapper of the ChunkSum-32 checksum kernel, and the counterpart of the
reference's one entry point, :func:`checksum_bytes`.

On a CUDA tensor :func:`chunksum32` launches ``csrc/checksum.cu``; on a
CPU tensor it runs the plain version in
:mod:`repro_torch.kernels.checksum.ref`.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch import kernels
from repro_torch.kernels import _build
from repro_torch.kernels.checksum import ref

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("checksum")
        lib.chunksum32_u8.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                      ctypes.c_void_p, ctypes.c_void_p]
        lib.chunksum32_u8.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def chunksum32(x: torch.Tensor) -> torch.Tensor:
    """x (L,) uint8 -> (2,) int32 holding the bits of ``A`` and ``B``
    (sums mod 2**32; see :mod:`repro_torch.kernels.checksum.ref`)."""
    if x.dim() != 1 or x.dtype != torch.uint8:
        raise ValueError(f"chunksum32 input must be a 1-D uint8 tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if x.device.type == "cpu":
        return ref.chunksum32(x)
    if x.device.type != "cuda":
        raise ValueError(f"chunksum32 runs on cuda or cpu, not {x.device}")
    if not x.is_contiguous():
        raise ValueError("chunksum32 input must be contiguous")
    sums = torch.empty(2, dtype=torch.int32, device=x.device)
    rc = _lib().chunksum32_u8(x.data_ptr(), x.numel(), sums.data_ptr(),
                              torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "checksum", "chunksum32_u8")
    kernels.launch_counts["checksum"] += 1
    return sums


def checksum_bytes(data: bytes, *,
                   device: Optional[_device.DeviceLike] = None) -> int:
    """ChunkSum-32 of ``data`` on ``device`` (the package default when
    None): ``(A & 0xFFFF) | ((B & 0xFFFF) << 16)``."""
    arr = np.frombuffer(data, dtype=np.uint8).copy()
    x = torch.from_numpy(arr).to(_device.resolve(device))
    return ref.combine(chunksum32(x))
