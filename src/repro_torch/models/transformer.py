"""Decoder-only transformer, dense family (granite / starcoder2 / yi /
gemma3): the reference's ``repro.models.transformer`` in PyTorch.

Parameters keep the reference's stacked-by-layer layout (every tensor of
``params["layers"]`` leads with the layer axis), so a reference tree
carries across leaf for leaf (:func:`repro_torch.convert.tree_from_reference`);
the reference's ``scan`` over layers is a Python loop over that axis.
Heterogeneous attention (gemma3's 5 local : 1 global) is a per-layer
window: 0 for global layers, ``sliding_window`` for local ones.

Prefill attention runs the flash attention kernel (``layers.attention``);
decode attends over the cache with the plain einsum attention, and so
does the training loss (``decoder_loss``, as the reference's default
``attn_impl="einsum"``).  MoE and the VLM backbone (M-RoPE, vision
prefix) are not ported yet: they raise ``NotImplementedError`` (ROADMAP
A3).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch import device as _device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

_NOT_PORTED = ("{what} is not ported to repro_torch yet (ROADMAP A3: "
               "MoE, VLM, encdec and hybrid serving and training come "
               "after the dense and ssm families)")


def padded_vocab(cfg: ModelConfig) -> int:
    return cfg.padded_vocab


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _check_dense(cfg: ModelConfig) -> None:
    if cfg.num_experts:
        raise NotImplementedError(_NOT_PORTED.format(what="MoE"))
    if cfg.mrope:
        raise NotImplementedError(_NOT_PORTED.format(
            what="M-RoPE / the vision prefix"))


def is_global_flags(cfg: ModelConfig) -> np.ndarray:
    """Per-layer bool: True = full/global attention, False = windowed."""
    flags = np.zeros((cfg.num_layers,), dtype=bool)
    if cfg.sliding_window == 0:
        flags[:] = True
    else:
        if cfg.global_every:
            flags[cfg.global_every - 1::cfg.global_every] = True
        for i in cfg.full_attn_layers:
            flags[i] = True
    return flags


def layer_windows(cfg: ModelConfig) -> list[int]:
    """Each layer's attention window (0 = global)."""
    return [0 if g else cfg.sliding_window for g in is_global_flags(cfg)]


# --------------------------------------------------------------------------
# Init
# --------------------------------------------------------------------------
def init_decoder(cfg: ModelConfig, gen: torch.Generator,
                 device: _device.DeviceLike | None = None) -> dict:
    """Random parameters in the reference's tree layout, drawn from
    ``gen`` (a generator on ``device``)."""
    _check_dense(cfg)
    dev = _device.resolve(device)
    dt = _dtype(cfg)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, KV, F, Lr = cfg.num_heads, cfg.num_kv_heads, cfg.d_ff, cfg.num_layers
    V = padded_vocab(cfg)

    def init(shape, fan):
        return L.dense_init(gen, shape, dt, fan, device=dev)

    layer = {
        "attn_norm": torch.ones((Lr, d), dtype=dt, device=dev),
        "mlp_norm": torch.ones((Lr, d), dtype=dt, device=dev),
        "wq": init((Lr, d, H, hd), d),
        "wk": init((Lr, d, KV, hd), d),
        "wv": init((Lr, d, KV, hd), d),
        "wo": init((Lr, H, hd, d), H * hd),
    }
    if cfg.mlp_type == "swiglu":
        layer["w_gate"] = init((Lr, d, F), d)
    layer["w_up"] = init((Lr, d, F), d)
    layer["w_down"] = init((Lr, F, d), F)
    params = {"embed": init((V, d), d),
              "final_norm": torch.ones((d,), dtype=dt, device=dev),
              "layers": layer}
    if not cfg.tie_embeddings:
        params["unembed"] = init((d, V), d)
    return params


def _layer(params: dict, i: int) -> dict:
    return {name: w[i] for name, w in params["layers"].items()}


# --------------------------------------------------------------------------
# Blocks
# --------------------------------------------------------------------------
def _attn_block(x, p, cos, sin, positions, window, impl):
    """Prefill self-attention of one layer: (output, k, v)."""
    q, k, v = L.qkv_proj(x, p["wq"], p["wk"], p["wv"])
    q = L.apply_rope(q, cos, sin)
    k = L.apply_rope(k, cos, sin)
    o = L.attention(q, k, v, q_pos=positions, kv_pos=positions, causal=True,
                    window=window, impl=impl)
    return L.out_proj(o, p["wo"]), k, v


def _ffn(x, p, cfg):
    """The dense feed-forward block (MoE is not ported)."""
    return L.mlp(x, p, cfg.mlp_type)


# --------------------------------------------------------------------------
# Forward (prefill hidden states)
# --------------------------------------------------------------------------
def decoder_hidden(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
                   attn_impl: str = "kernel", remat_policy: str = "none",
                   collect_kv: bool = False):
    """tokens (B,S) -> hidden (B,S,D); optionally per-layer (k, v) stacks
    (L, B, S, KV, hd).  ``remat_policy`` ``"full"`` or ``"dots"`` wraps
    each layer in ``torch.utils.checkpoint`` (non-reentrant), as the
    reference wraps its layer body in ``jax.checkpoint``; values are the
    same (there is no counterpart of the ``dots`` save policy: the whole
    layer is recomputed)."""
    _check_dense(cfg)
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device)[None].expand(B, S)
    cos, sin = L.rope_cos_sin(positions, cfg.resolved_head_dim,
                              cfg.rope_theta)
    x = L.embed_tokens(params["embed"], tokens)

    def body(h, p, window):
        attn_out, k, v = _attn_block(L.rmsnorm(h, p["attn_norm"]), p, cos,
                                     sin, positions[0], window, attn_impl)
        h = h + attn_out
        return h + _ffn(L.rmsnorm(h, p["mlp_norm"]), p, cfg), k, v

    ks, vs = [], []
    for p, window in zip(L.unstack_layers(params["layers"], 1),
                         layer_windows(cfg)):
        if remat_policy == "none":
            x, k, v = body(x, p, window)
        else:
            x, k, v = torch.utils.checkpoint.checkpoint(
                body, x, p, window, use_reentrant=False)
        if collect_kv:
            ks.append(k)
            vs.append(v)
    x = L.rmsnorm(x, params["final_norm"])
    if collect_kv:
        return x, (torch.stack(ks), torch.stack(vs))
    return x


def decoder_logits(cfg: ModelConfig, params: dict,
                   hidden: torch.Tensor) -> torch.Tensor:
    """(B,S,D) -> (B,S,Vpad) float32 logits."""
    return L.logits_from_hidden(hidden, params, cfg.tie_embeddings)


def decoder_loss(cfg: ModelConfig, params: dict, batch: dict, *,
                 remat_policy: str = "dots", loss_chunk: int = 0
                 ) -> torch.Tensor:
    """Mean next-token NLL of ``batch["tokens"]`` against
    ``batch["labels"]`` (labels < 0 masked).  With ``loss_chunk`` dividing
    the sequence, the logits are formed ``loss_chunk`` positions at a
    time, never all (B,S,V) at once."""
    _check_dense(cfg)
    hidden = decoder_hidden(cfg, params, batch["tokens"],
                            attn_impl="einsum", remat_policy=remat_policy)
    labels = batch["labels"]
    if loss_chunk and hidden.shape[1] % loss_chunk == 0:
        tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
        cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for h, lab in zip(hidden.split(loss_chunk, dim=1),
                          labels.split(loss_chunk, dim=1)):
            logits = decoder_logits(cfg, params, h).float()
            lse = torch.logsumexp(logits, dim=-1)
            gold = L._gold_logit(logits, lab)
            mask = (lab >= 0).float()
            tot = tot + torch.sum((lse - gold) * mask)
            cnt = cnt + torch.sum(mask)
        return tot / torch.clamp(cnt, min=1.0)
    return L.cross_entropy(decoder_logits(cfg, params, hidden), labels)


# --------------------------------------------------------------------------
# KV cache: prefill + decode
# --------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: _device.DeviceLike | None = None) -> dict:
    _check_dense(cfg)
    dev = _device.resolve(device)
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=_dtype(cfg), device=dev),
            "v": torch.zeros(shape, dtype=_dtype(cfg), device=dev),
            "pos": 0}


def grow_cache(cache: dict, max_len: int) -> dict:
    """The cache with its time axis zero-padded to ``max_len`` slots (what
    the reference's serve driver does with ``jnp.pad`` after a prefill)."""
    pad = max_len - cache["k"].shape[2]
    if pad < 0:
        raise ValueError(f"cache holds {cache['k'].shape[2]} slots, more "
                         f"than {max_len}")

    def grow(t):
        return torch.cat([t, t.new_zeros(t.shape[:2] + (pad,)
                                         + t.shape[3:])], dim=2)
    return dict(cache, k=grow(cache["k"]), v=grow(cache["v"]))


def decoder_prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
                    attn_impl: str = "kernel"):
    """Full-sequence forward that also returns the populated KV cache and the
    last-position logits (the realistic serve entry point)."""
    hidden, (k, v) = decoder_hidden(cfg, params, tokens, attn_impl=attn_impl,
                                    collect_kv=True)
    cache = {"k": k, "v": v, "pos": tokens.shape[1]}
    logits = L.logits_from_hidden(hidden[:, -1:], params,
                                  cfg.tie_embeddings)
    return logits[:, 0], cache


def decoder_decode(cfg: ModelConfig, params: dict, cache: dict,
                   tokens: torch.Tensor):
    """One decode step. tokens (B,1); cache KV (L,B,T,KV,hd); returns
    (logits (B,Vpad), new cache).  The cache tensors are written in place
    at slot ``pos`` (the reference returns updated copies)."""
    _check_dense(cfg)
    B, S1 = tokens.shape
    T = cache["k"].shape[2]
    pos = int(cache["pos"])
    if pos >= T:
        raise ValueError(f"decode at position {pos} but the cache holds "
                         f"{T} slots; grow it first")
    dev = tokens.device
    positions = torch.full((B, S1), pos, dtype=torch.int32, device=dev)
    cos, sin = L.rope_cos_sin(positions, cfg.resolved_head_dim,
                              cfg.rope_theta)
    x = L.embed_tokens(params["embed"], tokens)
    q_pos = torch.full((S1,), pos, dtype=torch.int32, device=dev)
    kv_pos = torch.arange(T, dtype=torch.int32, device=dev)
    kv_valid = (kv_pos <= pos)[None].expand(B, T)
    for i, window in enumerate(layer_windows(cfg)):
        p = _layer(params, i)
        attn_in = L.rmsnorm(x, p["attn_norm"])
        q, k_new, v_new = L.qkv_proj(attn_in, p["wq"], p["wk"], p["wv"])
        q = L.apply_rope(q, cos, sin)
        k_new = L.apply_rope(k_new, cos, sin)
        k_l, v_l = cache["k"][i], cache["v"][i]
        k_l[:, pos:pos + S1] = k_new
        v_l[:, pos:pos + S1] = v_new
        o = L.attention(q, k_l, v_l, q_pos=q_pos, kv_pos=kv_pos, causal=True,
                        window=window, kv_valid=kv_valid)
        x = x + L.out_proj(o, p["wo"])
        x = x + _ffn(L.rmsnorm(x, p["mlp_norm"]), p, cfg)
    x = L.rmsnorm(x, params["final_norm"])
    logits = L.logits_from_hidden(x, params, cfg.tie_embeddings)
    return logits[:, 0], dict(cache, pos=pos + S1)
