"""Front door of the flash attention kernel, in the model's layout:
``q (B,S,H,hd), k/v (B,T,KV,hd) -> (B,S,H,hd)``, f32 or bf16, GQA when
``KV`` divides ``H``.

On CUDA tensors it launches ``csrc/flash_attention.cu``, compiled at ``hd``
64, 128, 256 and 512; any other width up to 512 runs at the next compiled
one, zero-padded (:mod:`repro_torch.kernels.head_width`).  It counts the
launch in
:data:`repro_torch.kernels.launch_counts`; on CPU tensors it runs the plain
version in :mod:`repro_torch.kernels.flash_attention.ref`.  It never falls
back from one to the other.  The C launcher picks the kernel by (dtype,
hd): bf16 at hd 64, 128 and 256 runs on the tensor cores (wgmma fed by
TMA, whose tensor maps want 16-byte aligned bases), f32 and bf16 at hd 512
on the CUDA cores.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ref
from repro_torch.kernels.head_width import run_padded

#: head widths the kernel is compiled for
HEAD_DIMS = (64, 128, 256, 512)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("flash_attention")
        lib.flash_attention_fwd.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.flash_attention_fwd.restype = ctypes.c_int
        lib.flash_attention_smem_bytes.argtypes = [ctypes.c_int] * 2
        lib.flash_attention_smem_bytes.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def smem_bytes(dtype: torch.dtype, hd: int) -> int:
    """Dynamic shared memory of one CTA of the kernel that ``dtype`` and
    ``hd`` route to (builds and loads the library)."""
    return _lib().flash_attention_smem_bytes(_DTYPES[dtype], hd)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention wants q (B,S,H,hd) and k, v "
                         f"(B,T,KV,hd); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[2]:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not "
                         f"fit q {tuple(q.shape)} (batch, head width, "
                         f"KV heads dividing H)")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"flash_attention: mixed dtypes {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"flash_attention inputs on different devices: "
                         f"{q.device}, {k.device}, {v.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Attention of each query position ``s`` over keys ``t < T`` with
    ``t <= s`` if ``causal`` and ``s - t < window`` if ``window > 0``
    (positions from 0); scale ``hd ** -0.5``."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"the flash_attention kernel takes float32 or "
                         f"bfloat16; got {q.dtype}")
    return run_padded(_launch, q, k, v, causal, window, widths=HEAD_DIMS,
                      what="flash_attention")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            window: int, *, scale: float) -> torch.Tensor:
    """One launch at a compiled head width, with the caller's scale."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    if T == 0 or B * H > 65535:
        raise ValueError(f"flash_attention: T={T}, B*H={B * H} out of the "
                         f"kernel's range")
    q, k, v = (t.contiguous() if t.data_ptr() % 16 == 0 else t.clone(
        memory_format=torch.contiguous_format) for t in (q, k, v))
    out = torch.empty_like(q)
    if S == 0 or B == 0:
        return out
    rc = _lib().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, T,
        H, KV, hd, int(bool(causal)), int(window), scale,
        _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "flash_attention", "flash_attention_fwd")
    kernels.launch_counts["flash_attention"] += 1
    return out
