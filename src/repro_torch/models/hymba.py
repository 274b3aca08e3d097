"""Hymba hybrid backbone: each block runs attention heads and a Mamba
(selective-SSM) head in parallel on the same input, fuses the two
normalized streams by averaging, then a SwiGLU MLP; the reference's
``repro.models.hymba`` in PyTorch.  Sliding-window attention everywhere
except the configured full-attention layers (``is_global_flags``).

Prefill attention runs the flash attention kernel (its window per layer)
and the SSM head the log-step scan of :mod:`repro_torch.models.mamba`;
decode attends over the cache with the einsum attention and steps the
SSM state.  The loss runs the einsum attention under autograd, as the
reference's.  As there: no meta-token prefix, and the SSM inner width
equals d_model.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch import device as _device
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import constraint, gather_weights
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models.transformer import (default_positions, layer_windows,
                                            padded_vocab)


def init_hymba(cfg: ModelConfig, gen: torch.Generator,
               device: _device.DeviceLike | None = None) -> dict:
    """Random parameters in the reference's tree layout, drawn from
    ``gen`` (a generator on ``device``)."""
    dev = _device.resolve(device)
    dt = getattr(torch, cfg.dtype)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, KV, F_, Lr = cfg.num_heads, cfg.num_kv_heads, cfg.d_ff, cfg.num_layers

    def init(shape, fan):
        return L.dense_init(gen, shape, dt, fan, device=dev)

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=dev)
    layer = {
        "attn_norm": ones(Lr, d), "mlp_norm": ones(Lr, d),
        "fuse_norm_attn": ones(Lr, d), "fuse_norm_ssm": ones(Lr, d),
        "wq": init((Lr, d, H, hd), d),
        "wk": init((Lr, d, KV, hd), d),
        "wv": init((Lr, d, KV, hd), d),
        "wo": init((Lr, H, hd, d), H * hd),
        "w_in": init((Lr, d, d), d),
        "w_gate_ssm": init((Lr, d, d), d),
        "w_out_ssm": init((Lr, d, d), d),
        "w_gate": init((Lr, d, F_), d),
        "w_up": init((Lr, d, F_), d),
        "w_down": init((Lr, F_, d), F_),
        "ssm": M.init_ssm(init, (Lr,), d, cfg.ssm_state, cfg.ssm_conv, dt,
                          dev),
    }
    return {"embed": init((padded_vocab(cfg), d), d), "final_norm": ones(d),
            "layers": layer}


def hymba_param_specs(cfg: ModelConfig) -> dict:
    """Logical-axis tree mirroring ``init_hymba`` output."""
    layer = {
        "attn_norm": ("layers", None), "mlp_norm": ("layers", None),
        "fuse_norm_attn": ("layers", None), "fuse_norm_ssm": ("layers", None),
        "wq": ("layers", "w_data", "heads", "head_dim"),
        "wk": ("layers", "w_data", "kv_heads", "head_dim"),
        "wv": ("layers", "w_data", "kv_heads", "head_dim"),
        "wo": ("layers", "heads", "head_dim", "w_data"),
        "w_in": ("layers", "w_data", "d_inner"),
        "w_gate_ssm": ("layers", "w_data", "d_inner"),
        "w_out_ssm": ("layers", "d_inner", "w_data"),
        "w_gate": ("layers", "w_data", "d_ff"),
        "w_up": ("layers", "w_data", "d_ff"),
        "w_down": ("layers", "d_ff", "w_data"),
        "ssm": M.ssm_param_specs(),
    }
    return {"embed": ("vocab", "embed_d"), "final_norm": (None,),
            "layers": layer}


def _layers(params: dict) -> list[dict]:
    """Per-layer views of the stacked layers, the SSM head's under
    ``"ssm"``."""
    flat = dict(params["layers"])
    ssm = flat.pop("ssm")
    out = L.unstack_layers(flat, 1)
    for p, p_ssm in zip(out, L.unstack_layers(ssm, 1)):
        p["ssm"] = p_ssm
    return out


def _ssm_in(h, p):
    """The SSM head's input stream and gate from the normed block input."""
    return sh.matmul(h, p["w_in"]), sh.matmul(h, p["w_gate_ssm"])


def _fuse(x, attn_out, y, z, p, cfg):
    """The block's residual update: the mean of the two normed streams,
    then the MLP."""
    ssm_out = sh.matmul(y * F.silu(z), p["w_out_ssm"])
    x = x + 0.5 * (L.rmsnorm(attn_out, p["fuse_norm_attn"])
                   + L.rmsnorm(ssm_out, p["fuse_norm_ssm"]))
    return L.carry(x + L.mlp(L.rmsnorm(x, p["mlp_norm"]), p, cfg.mlp_type))


def _prefill_block(x, p, cfg, cos, sin, pos, window, impl):
    """One block over the whole sequence: (x, k, v, SSM state, conv tail)."""
    p = gather_weights(p)
    h = L.rmsnorm(x, p["attn_norm"])
    q, k, v = L.qkv_proj(h, p["wq"], p["wk"], p["wv"])
    q = L.apply_rope(q, cos, sin)
    k = L.apply_rope(k, cos, sin)
    o = L.attention(q, k, v, q_pos=pos, kv_pos=pos, causal=True,
                    window=window, impl=impl)
    xin, z = _ssm_in(h, p)
    y, ssm_state, _ = M.selective_scan(xin, p["ssm"])
    x = _fuse(x, L.out_proj(o, p["wo"]), y, z, p, cfg)
    return x, k, v, ssm_state, xin[:, -(cfg.ssm_conv - 1):, :]


def hymba_hidden(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                 remat_policy: str = "dots", attn_impl: str = "einsum",
                 collect: bool = False):
    """tokens (B,S) -> hidden (B,S,D); with ``collect`` also the per-layer
    stacks (k, v, SSM state, conv tail).  ``remat_policy`` other than
    ``"none"`` recomputes each block in the backward pass
    (``torch.utils.checkpoint``)."""
    positions = default_positions(tokens)
    cos, sin = L.rope_cos_sin(positions, cfg.resolved_head_dim,
                              cfg.rope_theta)
    pos = positions[0]
    x = constraint(L.embed_tokens(params["embed"], tokens),
                   "batch", "act_seq", None)
    outs = []
    for p, window in zip(_layers(params), layer_windows(cfg)):
        args = (x, p, cfg, cos, sin, pos, window, attn_impl)
        if remat_policy == "none":
            x, *state = _prefill_block(*args)
        else:
            x, *state = torch.utils.checkpoint.checkpoint(
                _prefill_block, *args, use_reentrant=False)
        if collect:           # in the cache's layout
            outs.append([constraint(t, *ax) for t, ax in zip(state, (
                ("batch", "kv_seq", "kv_heads", "head_dim"),) * 2 + (
                ("batch", "d_inner", None), ("batch", None, "d_inner")))])
    x = L.rmsnorm(x, params["final_norm"])
    if collect:
        return x, [torch.stack(t) for t in zip(*outs)]
    return x


def hymba_loss(cfg: ModelConfig, params: dict, batch: dict, *,
               remat_policy: str = "dots", attn_impl: str = "einsum",
               **_) -> torch.Tensor:
    """Mean next-token NLL, attention by ``attn_impl`` (the reference's
    default ``"einsum"``, or ``"chunked"``)."""
    hidden = hymba_hidden(cfg, params, batch["tokens"], remat_policy,
                          attn_impl)
    logits = L.logits_from_hidden(hidden, params, "unembed" not in params)
    return L.cross_entropy(logits, batch["labels"])


# --------------------------------------------------------------------------
# Serving
# --------------------------------------------------------------------------
def init_hymba_cache(cfg: ModelConfig, batch: int, max_len: int,
                     device: _device.DeviceLike | None = None) -> dict:
    dev = _device.resolve(device)
    dt = getattr(torch, cfg.dtype)
    KV, hd, Lr, d = (cfg.num_kv_heads, cfg.resolved_head_dim, cfg.num_layers,
                     cfg.d_model)
    return {
        "k": torch.zeros((Lr, batch, max_len, KV, hd), dtype=dt, device=dev),
        "v": torch.zeros((Lr, batch, max_len, KV, hd), dtype=dt, device=dev),
        "ssm": torch.zeros((Lr, batch, d, cfg.ssm_state),
                           dtype=torch.float32, device=dev),
        "conv": torch.zeros((Lr, batch, cfg.ssm_conv - 1, d), dtype=dt,
                            device=dev),
        "pos": 0,
    }


def hymba_cache_specs(cfg: ModelConfig) -> dict:
    return {"k": ("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
            "v": ("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
            "ssm": ("layers", "batch", "d_inner", None),
            "conv": ("layers", "batch", None, "d_inner"),
            "pos": ()}


def hymba_prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                  attn_impl: str = "kernel"):
    """Parallel prompt processing: last-token logits (tied embedding, as
    the reference's) and the serve cache (KV per layer, SSM state, conv
    tail)."""
    x, (k, v, ssm, conv) = hymba_hidden(cfg, params, tokens, "none",
                                        attn_impl, collect=True)
    logits = L.logits_from_hidden(x[:, -1:], params, True)[:, 0]
    return logits, {"k": k, "v": v, "ssm": ssm, "conv": conv,
                    "pos": tokens.shape[1]}


def hymba_decode(cfg: ModelConfig, params: dict, cache: dict,
                 tokens: torch.Tensor):
    """One decode step, tokens (B,1).  The cache's k / v are written in
    place at slot ``pos``; the SSM state and conv tail come back new."""
    B, S1 = tokens.shape
    T = cache["k"].shape[2]
    pos = int(cache["pos"])
    if pos >= T:
        raise ValueError(f"decode at position {pos} but the cache holds "
                         f"{T} slots; grow it first")
    dev = tokens.device
    cos, sin = L.rope_cos_sin(
        torch.full((B, S1), pos, dtype=torch.int32, device=dev),
        cfg.resolved_head_dim, cfg.rope_theta)
    x = L.embed_tokens(params["embed"], tokens)
    q_pos = torch.full((S1,), pos, dtype=torch.int32, device=dev)
    kv_pos = torch.arange(T, dtype=torch.int32, device=dev)
    kv_valid = (kv_pos <= pos)[None].expand(B, T)
    ssm, conv = [], []
    for i, (p, window) in enumerate(zip(_layers(params),
                                        layer_windows(cfg))):
        p = gather_weights(p)
        h = L.rmsnorm(x, p["attn_norm"])
        q, k_new, v_new = L.qkv_proj(h, p["wq"], p["wk"], p["wv"])
        q = L.apply_rope(q, cos, sin)
        k_l, v_l = cache["k"][i], cache["v"][i]
        L.write_cache(k_l, L.apply_rope(k_new, cos, sin), pos)
        L.write_cache(v_l, v_new, pos)
        o = L.attention(q, k_l, v_l, q_pos=q_pos, kv_pos=kv_pos, causal=True,
                        window=window, kv_valid=kv_valid)
        xin, z = _ssm_in(h, p)
        y, s_new, c_new = M.selective_scan(xin, p["ssm"],
                                           state=cache["ssm"][i],
                                           conv_state=cache["conv"][i])
        ssm.append(s_new)
        conv.append(c_new)
        x = _fuse(x, L.out_proj(o, p["wo"]), y, z, p, cfg)
    x = L.rmsnorm(x, params["final_norm"])
    logits = L.logits_from_hidden(x, params, True)[:, 0]
    return logits, dict(cache, ssm=torch.stack(ssm), conv=torch.stack(conv),
                        pos=pos + S1)
