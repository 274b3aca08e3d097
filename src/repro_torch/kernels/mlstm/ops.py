"""Front door of the chunkwise mLSTM kernels: ``q/k/v (B,S,nh,dh)``, raw
gate logits ``i_gate/f_gate (B,S,nh)`` -> ``(B,S,nh,dh)`` in ``v``'s type
(f32 or bf16).

On CUDA tensors it launches one of the two kernels of ``csrc/mlstm.cu``,
chosen by (dtype, dh) in :data:`ROUTES`, and counts the launch in
:data:`repro_torch.kernels.launch_counts`; on CPU tensors it runs the
plain version, :func:`repro_torch.kernels.mlstm.ref.mlstm_parallel`.  It
never falls back from one to another.  A head width between the compiled
ones runs at the next compiled width, zero-padded
(:mod:`repro_torch.kernels.head_width`); a dtype outside the table, or a
width above 512, raises.  q, k and v are copied first if their base is off the 16-byte
grid that TMA and the vector loads need.

* bfloat16 at dh 512 (xlstm-350m's width): ``mlstm_wgmma_kernel``, bf16
  ``wgmma`` on the tensor cores fed by TMA.  The wrapper forms the gate
  terms of :func:`gate_terms` (G, M and the floor, each (B*nh, S) f32), so
  the kernel knows each row's stabiliser before its loop.
* float32 at dh 64, 128, 256, 512 and bfloat16 at dh 64, 128, 256:
  ``mlstm_kernel``, f32 FMAs on the CUDA cores, fed
  ``F = cumsum(log sigmoid(f))`` (an O(S) pass outside the kernel, as the
  TPU version does) and the raw input gates, each (B, S, nh) f32.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch import kernels
from repro_torch.kernels import _build
from repro_torch.kernels.head_width import run_padded
from repro_torch.kernels.mlstm import ref

#: head widths the kernels are compiled for
HEAD_DIMS = (64, 128, 256, 512)
#: (dtype, dh) -> the kernel that runs it
ROUTES = {**{(torch.float32, dh): "mlstm_kernel" for dh in HEAD_DIMS},
          **{(torch.bfloat16, dh): "mlstm_kernel" for dh in (64, 128, 256)},
          (torch.bfloat16, 512): "mlstm_wgmma_kernel"}
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
        lib.mlstm_wgmma_fwd.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
            + [ctypes.c_float, ctypes.c_void_p])
        lib.mlstm_wgmma_fwd.restype = ctypes.c_int
        lib.mlstm_wgmma_smem_bytes.argtypes = []
        lib.mlstm_wgmma_smem_bytes.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def smem_bytes() -> int:
    """Dynamic shared memory of one CTA of the tensor-core kernel (builds
    and loads the library)."""
    return _lib().mlstm_wgmma_smem_bytes()


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


def gate_terms(i_gate: torch.Tensor, f_gate: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The stabiliser of every row, known before the kernel's loop, from
    the raw gates ``(B,S,nh)`` (CPU or CUDA tensors).

    With ``F = cumsum(log sigmoid(f))``, ``G = i - F`` and its prefix max
    ``M_q = max_{k<=q} G_k``, the plain version's row max of
    ``D_qk = F_q - F_k + i_k`` is ``m_q = F_q + M_q``, so
    ``D_qk - m_q = G_k - M_q`` and the floor ``exp(-m_q) =
    exp(-(F_q + M_q))``.  Returns ``(G, M, floor)``, each ``(B, nh, S)``
    f32 and contiguous: the ``(B*nh, S)`` layout the kernel reads.
    """
    # Scans along the innermost dimension: PyTorch's CUDA scan over an
    # outer one walks the sequence in one thread per (batch, head).
    i_bh, f_bh = (t.float().transpose(1, 2).contiguous()
                  for t in (i_gate, f_gate))
    cum = torch.cumsum(F.logsigmoid(f_bh), dim=-1)
    g = i_bh - cum
    m = torch.cummax(g, dim=-1).values
    return g, m, torch.exp(-(cum + m))


def _tma_ready(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous, on a 16-byte aligned base (copied if not)."""
    if t.data_ptr() % 16 == 0:
        return t.contiguous()
    return t.clone(memory_format=torch.contiguous_format)


def mlstm(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          i_gate: torch.Tensor, f_gate: torch.Tensor) -> torch.Tensor:
    """The stabilized mLSTM over the whole sequence (causal)."""
    _check(q, k, v, i_gate, f_gate)
    if q.device.type == "cpu":
        return ref.mlstm_parallel(q, k, v, i_gate, f_gate)
    if q.device.type != "cuda":
        raise ValueError(f"mlstm runs on cuda or cpu, not {q.device}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"the mlstm kernels take float32 or bfloat16; got "
                         f"{q.dtype}")
    return run_padded(_launch, q, k, v, i_gate, f_gate, widths=HEAD_DIMS,
                      what="mlstm")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            i_gate: torch.Tensor, f_gate: torch.Tensor, *,
            scale: float) -> torch.Tensor:
    """One launch at a compiled head width, with the caller's scale."""
    B, S, nh, dh = q.shape
    route = ROUTES[(q.dtype, dh)]
    if B * nh > 65535:
        raise ValueError(f"mlstm: B*nh={B * nh} out of the kernel's range")
    q, k, v = (_tma_ready(t) for t in (q, k, v))
    out = torch.empty_like(v)
    if S == 0 or B == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if route == "mlstm_wgmma_kernel":
        g, m, floor = gate_terms(i_gate, f_gate)
        rc = _lib().mlstm_wgmma_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            m.data_ptr(), floor.data_ptr(), out.data_ptr(), B, S, nh, dh,
            scale, stream)
        _build.check(rc, "mlstm", "mlstm_wgmma_fwd")
    else:
        cum = torch.cumsum(F.logsigmoid(f_gate.float()), dim=1).contiguous()
        ig = i_gate.float().contiguous()
        rc = _lib().mlstm_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), cum.data_ptr(),
            ig.data_ptr(), out.data_ptr(), B, S, nh, dh, scale,
            _DTYPES[q.dtype], stream)
        _build.check(rc, "mlstm", "mlstm_fwd")
    kernels.launch_counts["mlstm"] += 1
    return out
