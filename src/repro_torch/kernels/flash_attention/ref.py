"""Plain PyTorch version of the flash attention kernel.

``attention_ref`` is the reference's oracle
(``repro.kernels.flash_attention.ref.attention_ref``): f32 scores and
softmax, the probabilities cast to ``v``'s type before the PV product,
f32 accumulation.  ``flash_attention`` takes the model layout with GQA
and expands the KV heads.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  scale: float | None = None) -> torch.Tensor:
    """q: (B,H,S,hd), k/v: (B,H,T,hd) -> (B,H,S,hd). f32 softmax; the
    scale is ``hd ** -0.5`` unless given."""
    S, T = q.shape[2], k.shape[2]
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    qi = torch.arange(S, device=q.device)[:, None]
    ki = torch.arange(T, device=q.device)[None, :]
    ok = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        ok = ok & (ki <= qi)
    if window > 0:
        ok = ok & (qi - ki < window)
    s = torch.where(ok, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: float | None = None) -> torch.Tensor:
    """q: (B,S,H,hd); k/v: (B,T,KV,hd) -> (B,S,H,hd); KV heads repeated."""
    H, KV = q.shape[2], k.shape[2]
    if KV != H:
        k = k.repeat_interleave(H // KV, dim=2)
        v = v.repeat_interleave(H // KV, dim=2)
    out = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=causal, window=window,
                       scale=scale)
    return out.transpose(1, 2)
