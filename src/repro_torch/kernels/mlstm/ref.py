"""Plain PyTorch version of the chunkwise mLSTM kernel: the stabilized
parallel (quadratic) form, the reference's ``mlstm_parallel``
(``repro.models.xlstm``), which the reference's oracle
``repro.kernels.mlstm.ref.mlstm_ref`` delegates to.

One difference, the Pallas kernel's: the gated scores are cast to ``v``'s
type before the product with ``v`` (the reference's parallel form keeps
them in f32).  In f32 the two are the same function.

:func:`mlstm_known_stabiliser` is the same function in the tensor-core
kernel's form: each row's stabiliser given up front as the gate terms of
``ops.gate_terms``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def mlstm_parallel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   i_gate: torch.Tensor, f_gate: torch.Tensor
                   ) -> torch.Tensor:
    """q/k/v: (B,S,nh,dh); i/f raw gate logits: (B,S,nh) -> h (B,S,nh,dh).

    D[t,s] = cumlogsig(f)[t] - cumlogsig(f)[s] + i[s]  (s <= t), stabilized
    per row; h = (exp(D - m) * (q k^T / sqrt(dh))) v / max(|row sum|, e^-m).
    """
    B, S, nh, dh = q.shape
    logf = F.logsigmoid(f_gate.float())                        # (B,S,nh)
    cum = torch.cumsum(logf, dim=1)
    ii = i_gate.float()
    D = cum[:, :, None, :] - cum[:, None, :, :] + ii[:, None, :, :]
    t_idx = torch.arange(S, device=q.device)
    causal = t_idx[:, None] >= t_idx[None, :]
    D = torch.where(causal[None, :, :, None], D, -torch.inf)   # (B,t,s,nh)
    m = torch.amax(D, dim=2, keepdim=True)                      # (B,t,1,nh)
    d_exp = torch.exp(D - m)
    scores = torch.einsum("bthd,bshd->btsh", q.float(), k.float())
    scores = scores * (dh ** -0.5) * d_exp
    norm = torch.maximum(torch.abs(scores.sum(dim=2)),
                         torch.exp(-m[:, :, 0, :]))              # (B,t,nh)
    h = torch.einsum("btsh,bshd->bthd", scores.to(v.dtype).float(),
                     v.float())
    return (h / norm[..., None]).to(v.dtype)



def mlstm_known_stabiliser(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           G: torch.Tensor, M: torch.Tensor,
                           floor: torch.Tensor) -> torch.Tensor:
    """q/k/v: (B,S,nh,dh); G, M, floor: (B,nh,S) f32 (``ops.gate_terms``)
    -> h (B,S,nh,dh).

    s[t,s'] = (q k^T / sqrt(dh)) * exp(G[s'] - M[t])  (s' <= t);
    h = s.astype(v.dtype) v / max(|row sum of s|, floor[t]).
    """
    B, S, nh, dh = q.shape
    t_idx = torch.arange(S, device=q.device)
    causal = t_idx[:, None] >= t_idx[None, :]
    E = torch.where(causal, G[:, :, None, :] - M[:, :, :, None], -torch.inf)
    scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float())
    scores = scores * (dh ** -0.5) * torch.exp(E)               # (B,nh,t,s)
    norm = torch.maximum(torch.abs(scores.sum(dim=-1)), floor)   # (B,nh,t)
    h = torch.einsum("bhts,bshd->bthd", scores.to(v.dtype).float(),
                     v.float())
    return (h / norm.transpose(1, 2)[..., None]).to(v.dtype)
