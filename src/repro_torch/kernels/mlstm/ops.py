"""Front door of the chunkwise mLSTM kernel: ``q/k/v (B,S,nh,dh)``, raw
gate logits ``i_gate/f_gate (B,S,nh)`` -> ``(B,S,nh,dh)`` in ``v``'s type
(f32 or bf16).

On CUDA tensors it forms ``F = cumsum(log sigmoid(f))`` in f32 (an O(S)
pass outside the kernel, as the TPU version does), launches
``csrc/mlstm.cu`` (``dh`` in 64, 128, 256, 512) and counts the launch in
:data:`repro_torch.kernels.launch_counts`; on CPU tensors it runs the
plain version, :func:`repro_torch.kernels.mlstm.ref.mlstm_parallel`.  It
never falls back from one to the other.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch import kernels
from repro_torch.kernels import _build
from repro_torch.kernels.mlstm import ref

#: head widths the kernel is compiled for
HEAD_DIMS = (64, 128, 256, 512)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("mlstm")
        lib.mlstm_fwd.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                                  + [ctypes.c_float, ctypes.c_int,
                                     ctypes.c_void_p])
        lib.mlstm_fwd.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check(q, k, v, i_gate, f_gate) -> None:
    if q.dim() != 4 or not (q.shape == k.shape == v.shape):
        raise ValueError(f"mlstm wants q, k, v of one shape (B,S,nh,dh); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if i_gate.shape != q.shape[:3] or f_gate.shape != q.shape[:3]:
        raise ValueError(f"mlstm gates must be {tuple(q.shape[:3])}; got "
                         f"{tuple(i_gate.shape)}, {tuple(f_gate.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"mlstm: mixed dtypes {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    devs = {t.device for t in (q, k, v, i_gate, f_gate)}
    if len(devs) != 1:
        raise ValueError(f"mlstm inputs on different devices: {devs}")


def mlstm(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          i_gate: torch.Tensor, f_gate: torch.Tensor) -> torch.Tensor:
    """The stabilized mLSTM over the whole sequence (causal)."""
    _check(q, k, v, i_gate, f_gate)
    if q.device.type == "cpu":
        return ref.mlstm_parallel(q, k, v, i_gate, f_gate)
    if q.device.type != "cuda":
        raise ValueError(f"mlstm runs on cuda or cpu, not {q.device}")
    B, S, nh, dh = q.shape
    if q.dtype not in _DTYPES or dh not in HEAD_DIMS:
        raise ValueError(f"the mlstm kernel takes float32 or bfloat16 with "
                         f"dh in {HEAD_DIMS}; got {q.dtype}, dh={dh}")
    if B * nh > 65535:
        raise ValueError(f"mlstm: B*nh={B * nh} out of the kernel's range")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    cum = torch.cumsum(F.logsigmoid(f_gate.float()), dim=1).contiguous()
    ig = i_gate.float().contiguous()
    out = torch.empty_like(v)
    if S == 0 or B == 0:
        return out
    rc = _lib().mlstm_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), cum.data_ptr(),
        ig.data_ptr(), out.data_ptr(), B, S, nh, dh, dh ** -0.5,
        _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "mlstm", "mlstm_fwd")
    kernels.launch_counts["mlstm"] += 1
    return out
