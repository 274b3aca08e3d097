"""Selective SSM (Mamba-style) head of the Hymba hybrid blocks: the
reference's ``repro.models.mamba`` in PyTorch.

Prefill runs the linear recurrence h_t = a_t * h_{t-1} + b_t over the
whole sequence in ceil(log2 S) steps (:func:`linear_scan`, a
Hillis-Steele scan: each step composes every element with the one
``2^j`` before it), as the reference's ``jax.lax.associative_scan`` does
in log depth; a loop over the tokens would cost a launch each.  Decode is
the one-step recurrence.  The depthwise short conv is a causal 1D conv
(kernel ``ssm_conv``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding as sh


def init_ssm(init, shape_prefix: tuple, d_inner: int, n_state: int,
             conv: int, dtype: torch.dtype, device) -> dict:
    """The SSM head's parameters in the reference's layout, each random
    tensor drawn by ``init(shape, fan_in)``."""
    sp = tuple(shape_prefix)

    def full(shape, value):
        return torch.full(sp + shape, value, dtype=dtype, device=device)
    return {
        "conv_w": init(sp + (conv, d_inner), conv),
        "w_dt": init(sp + (d_inner, d_inner), d_inner),
        "b_dt": full((d_inner,), -4.6),          # softplus^-1(~0.01)
        "w_B": init(sp + (d_inner, n_state), d_inner),
        "w_C": init(sp + (d_inner, n_state), d_inner),
        "A_log": full((d_inner, n_state), 0.0),
        "D": full((d_inner,), 1.0),
    }


def ssm_param_specs() -> dict:
    """Logical-axis tree mirroring ``init_ssm`` output (stacked by
    layer)."""
    return {
        "conv_w": ("layers", None, "d_inner"),
        "w_dt": ("layers", "w_data", "d_inner"),
        "b_dt": ("layers", "d_inner"),
        "w_B": ("layers", "w_data", None),
        "w_C": ("layers", "w_data", None),
        "A_log": ("layers", "d_inner", None),
        "D": ("layers", "d_inner"),
    }


def causal_conv(x: torch.Tensor, w: torch.Tensor,
                state: torch.Tensor | None = None):
    """Depthwise causal conv. x (B,S,D), w (K,D). With ``state`` (B,K-1,D)
    takes one streaming step (decode) and returns (y, new_state); else
    (y, None)."""
    K = w.shape[0]
    if state is not None:
        window = torch.cat([state, x], dim=1)          # (B,K,D) for S=1
        y = sh.einsum("bkd,kd->bd", window[:, -K:], w)[:, None]
        return y, window[:, 1:]
    pad = F.pad(x, (0, 0, K - 1, 0))
    y = sum(pad[:, i:i + x.shape[1]] * w[i] for i in range(K))
    return y, None


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t along dim 1, from h_{-1} = 0: every
    (a, b) pair composed with the one ``d`` before it for d = 1, 2, 4, ...
    (the associative operator of the reference's scan), so after
    ceil(log2 S) steps ``b`` holds h."""
    d = 1
    while d < a.shape[1]:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def selective_scan(x: torch.Tensor, p: dict, *, state=None, conv_state=None):
    """x: (B,S,Di) pre-activation stream. Returns (y (B,S,Di), new_state
    (B,Di,N) float32, new_conv_state). ``state`` triggers the single-step
    decode (with ``conv_state``)."""
    xc, new_conv = causal_conv(x, p["conv_w"], conv_state)
    xc = F.silu(xc)
    dt = F.softplus(sh.matmul(xc, p["w_dt"]) + p["b_dt"])
    Bm = sh.matmul(xc, p["w_B"])
    Cm = sh.matmul(xc, p["w_C"])
    A = -torch.exp(p["A_log"].float())                   # (Di,N)
    a = torch.exp(dt[..., None].float() * A)             # (B,S,Di,N)
    b = (dt[..., None] * Bm[:, :, None, :] * xc[..., None]).float()
    if state is None:
        h = linear_scan(a, b)
        new_state = h[:, -1]
    else:
        h = a[:, 0] * state + b[:, 0]                    # (B,Di,N)
        new_state = h
        h = h[:, None]
    y = sh.einsum("bsdn,bsn->bsd", h.to(Cm.dtype), Cm)
    y = y + p["D"] * xc
    return y.to(x.dtype), new_state, new_conv

