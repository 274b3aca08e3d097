"""Plain PyTorch version of the chunkwise mLSTM kernel: the stabilized
parallel (quadratic) form, the reference's ``mlstm_parallel``
(``repro.models.xlstm``), which the reference's oracle
``repro.kernels.mlstm.ref.mlstm_ref`` delegates to.  Its body is the
port's model form, ``repro_torch.models.xlstm.mlstm_parallel``.

One difference, the Pallas kernel's: the gated scores are cast to ``v``'s
type before the product with ``v`` (the reference's parallel form keeps
them in f32).  In f32 the two are the same function.

:func:`mlstm_known_stabiliser` is the same function in the tensor-core
kernel's form: each row's stabiliser given up front as the gate terms of
``ops.gate_terms``.
"""

from __future__ import annotations

import torch

# The model module imports this package's ops (and so this module) too:
# import the module, not its names, so either may load first.
from repro_torch.models import xlstm as _model


def mlstm_parallel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   i_gate: torch.Tensor, f_gate: torch.Tensor, *,
                   scale: float | None = None) -> torch.Tensor:
    """q/k/v: (B,S,nh,dh); i/f raw gate logits: (B,S,nh) -> h (B,S,nh,dh):
    the model's parallel form with the scores rounded to v's type before
    the PV product.  ``scale`` replaces ``1 / sqrt(dh)`` when given."""
    return _model.mlstm_parallel(q, k, v, i_gate, f_gate, scale=scale,
                                 round_scores=True)


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
