"""Whisper-style encoder-decoder backbone: the reference's
``repro.models.encdec`` in PyTorch.

The audio conv frontend is a stub, as there: callers supply precomputed
frame embeddings (B, encoder_seq, d_model), which the encoder takes in
the model's dtype.  Positions are sinusoidal (parameter-free) on both
sides; norms are RMSNorm.

Serving: the encoder's bidirectional self-attention, the decoder prefill's
causal self-attention and its cross-attention over the encoder's frames
(S queries over ``encoder_seq`` keys, no mask) go through the flash
attention kernel; decode steps attend over the self-KV cache and the
fixed cross-KV with the einsum attention.  The loss runs the einsum
attention throughout, as the reference's.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch import device as _device
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import constraint, gather_weights
from repro_torch.models import layers as L
from repro_torch.models.transformer import padded_vocab


def sinusoidal(seq: int, d: int, dtype: torch.dtype,
               device=None) -> torch.Tensor:
    """(seq, d) sin / cos position table, computed in float64 (numpy, as
    the reference's) and cast."""
    pos = np.arange(seq)[:, None]
    dim = np.arange(d // 2)[None]
    ang = pos / np.power(10000.0, 2 * dim / d)
    out = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.from_numpy(out).to(device=device, dtype=dtype)


def _sinusoidal_at(pos: int, d: int, dtype: torch.dtype,
                   device) -> torch.Tensor:
    """One row of the table in float32 (the reference's decode step)."""
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)
    ang = torch.tensor(float(pos), device=device) / torch.pow(
        torch.tensor(10000.0, device=device), 2 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)]).to(dtype)


def init_encdec(cfg: ModelConfig, gen: torch.Generator,
                device: _device.DeviceLike | None = None) -> dict:
    """Random parameters in the reference's tree layout, drawn from
    ``gen`` (a generator on ``device``)."""
    dev = _device.resolve(device)
    dt = getattr(torch, cfg.dtype)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, KV, F_ = cfg.num_heads, cfg.num_kv_heads, cfg.d_ff
    Le, Ld = cfg.encoder_layers, cfg.num_layers

    def init(shape, fan):
        return L.dense_init(gen, shape, dt, fan, device=dev)

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=dev)

    def attn(Lr, prefix=""):
        return {prefix + "wq": init((Lr, d, H, hd), d),
                prefix + "wk": init((Lr, d, KV, hd), d),
                prefix + "wv": init((Lr, d, KV, hd), d),
                prefix + "wo": init((Lr, H, hd, d), H * hd)}
    enc = {"attn_norm": ones(Le, d), "mlp_norm": ones(Le, d),
           "w_up": init((Le, d, F_), d), "w_down": init((Le, F_, d), F_),
           **attn(Le)}
    dec = {"attn_norm": ones(Ld, d), "cross_norm": ones(Ld, d),
           "mlp_norm": ones(Ld, d),
           "w_up": init((Ld, d, F_), d), "w_down": init((Ld, F_, d), F_),
           **attn(Ld), **attn(Ld, "c")}
    V = padded_vocab(cfg)
    return {"embed": init((V, d), d), "unembed": init((d, V), d),
            "enc_layers": enc, "dec_layers": dec, "enc_norm": ones(d),
            "dec_norm": ones(d)}


def encdec_param_specs(cfg: ModelConfig) -> dict:
    """Logical-axis tree mirroring ``init_encdec`` output."""
    att = {
        "wq": ("layers", "w_data", "heads", "head_dim"),
        "wk": ("layers", "w_data", "kv_heads", "head_dim"),
        "wv": ("layers", "w_data", "kv_heads", "head_dim"),
        "wo": ("layers", "heads", "head_dim", "w_data"),
    }
    mlp = {"w_up": ("layers", "w_data", "d_ff"),
           "w_down": ("layers", "d_ff", "w_data")}
    return {
        "embed": ("vocab", "embed_d"),
        "unembed": ("embed_d", "vocab"),
        "enc_layers": {"attn_norm": ("layers", None),
                       "mlp_norm": ("layers", None), **att, **mlp},
        "dec_layers": {"attn_norm": ("layers", None),
                       "cross_norm": ("layers", None),
                       "mlp_norm": ("layers", None), **att, **mlp,
                       **{"c" + k: v for k, v in att.items()}},
        "enc_norm": (None,),
        "dec_norm": (None,),
    }


def _remat(body, remat_policy: str):
    if remat_policy == "none":
        return body
    return lambda *a: torch.utils.checkpoint.checkpoint(body, *a,
                                                        use_reentrant=False)


# --------------------------------------------------------------------------
# Encoder
# --------------------------------------------------------------------------
def encode(cfg: ModelConfig, params: dict, frames: torch.Tensor,
           remat_policy: str = "dots", attn_impl: str = "einsum"
           ) -> torch.Tensor:
    """frames (B, Te, d) -> encoder states (B, Te, d); bidirectional
    self-attention by ``attn_impl`` (the flash attention kernel for
    serving, the einsum attention for the loss)."""
    dt = params["enc_norm"].dtype
    B, Te, d = frames.shape
    x = frames.to(dt) + sinusoidal(Te, d, dt, frames.device)[None]
    x = constraint(x, "batch", "act_seq", None)
    pos = torch.arange(Te, dtype=torch.int32, device=frames.device)

    def body(h, p):
        p = gather_weights(p)
        q, k, v = L.qkv_proj(L.rmsnorm(h, p["attn_norm"]), p["wq"], p["wk"],
                             p["wv"])
        o = L.attention(q, k, v, q_pos=pos, kv_pos=pos, causal=False,
                        impl=attn_impl)
        h = h + L.out_proj(o, p["wo"])
        return L.carry(h + L.mlp(L.rmsnorm(h, p["mlp_norm"]), p, "gelu"))

    body = _remat(body, remat_policy)
    for p in L.unstack_layers(params["enc_layers"], 1):
        x = body(x, p)
    return L.rmsnorm(x, params["enc_norm"])


# --------------------------------------------------------------------------
# Decoder
# --------------------------------------------------------------------------
def _decoder(cfg, params, tokens, enc_out, remat_policy, attn_impl,
             collect=False):
    """The decoder over the whole prompt: hidden (B,S,D), and with
    ``collect`` the per-layer stacks (k, v, ck, cv).  Self-attention by
    ``attn_impl``; cross-attention by it too, except that ``"chunked"``
    chunks the self-attention alone (the reference's cross-attention is
    its einsum attention)."""
    cross_impl = "einsum" if attn_impl == "chunked" else attn_impl
    B, S = tokens.shape
    x = L.embed_tokens(params["embed"], tokens)
    x = x + sinusoidal(S, cfg.d_model, x.dtype, x.device)[None]
    pos = torch.arange(S, dtype=torch.int32, device=x.device)
    epos = torch.arange(enc_out.shape[1], dtype=torch.int32, device=x.device)

    def body(h, p):
        p = gather_weights(p)
        q, k, v = L.qkv_proj(L.rmsnorm(h, p["attn_norm"]), p["wq"], p["wk"],
                             p["wv"])
        o = L.attention(q, k, v, q_pos=pos, kv_pos=pos, causal=True,
                        impl=attn_impl)
        h = h + L.out_proj(o, p["wo"])
        cq = sh.einsum("bsd,dnh->bsnh", L.rmsnorm(h, p["cross_norm"]),
                          p["cwq"])
        # cross K/V come from the encoder stream
        ck = sh.einsum("btd,dkh->btkh", enc_out, p["cwk"])
        cv = sh.einsum("btd,dkh->btkh", enc_out, p["cwv"])
        co = L.attention(cq, ck, cv, q_pos=pos, kv_pos=epos, causal=False,
                         impl=cross_impl)
        h = h + L.out_proj(co, p["cwo"])
        h = L.carry(h + L.mlp(L.rmsnorm(h, p["mlp_norm"]), p, "gelu"))
        return h, k, v, ck, cv

    body = _remat(body, remat_policy)
    outs = []
    cache_axes = [("batch", "kv_seq", "kv_heads", "head_dim")] * 2 + \
        [("batch", None, "kv_heads", "head_dim")] * 2
    for p in L.unstack_layers(params["dec_layers"], 1):
        x, *kv = body(x, p)
        if collect:           # in the cache's layout
            outs.append([constraint(t, *ax) for t, ax in zip(kv, cache_axes)])
    x = L.rmsnorm(x, params["dec_norm"])
    if collect:
        return x, [torch.stack(t) for t in zip(*outs)]
    return x


def decode_train(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                 enc_out: torch.Tensor, remat_policy: str = "dots",
                 attn_impl: str = "einsum") -> torch.Tensor:
    """tokens (B,S) over encoder states -> decoder hidden (B,S,D)."""
    return _decoder(cfg, params, tokens, enc_out, remat_policy, attn_impl)


def encdec_loss(cfg: ModelConfig, params: dict, batch: dict, *,
                remat_policy: str = "dots", attn_impl: str = "einsum",
                **_) -> torch.Tensor:
    """Mean next-token NLL of the decoder over ``batch["frames"]``; the
    encoder's attention einsum, the decoder's by ``attn_impl`` (the
    reference's default ``"einsum"``, or ``"chunked"``)."""
    enc_out = encode(cfg, params, batch["frames"], remat_policy)
    hidden = decode_train(cfg, params, batch["tokens"], enc_out,
                          remat_policy, attn_impl)
    logits = L.logits_from_hidden(hidden, params, False)
    return L.cross_entropy(logits, batch["labels"])


# --------------------------------------------------------------------------
# Serving: prefill + decode with self-KV cache and fixed cross-KV
# --------------------------------------------------------------------------
def encdec_cache_specs(cfg: ModelConfig) -> dict:
    kv = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
    ckv = ("layers", "batch", None, "kv_heads", "head_dim")
    return {"k": kv, "v": kv, "ck": ckv, "cv": ckv, "pos": ()}


def init_encdec_cache(cfg: ModelConfig, batch: int, max_len: int,
                      device: _device.DeviceLike | None = None) -> dict:
    dev = _device.resolve(device)
    dt = getattr(torch, cfg.dtype)
    KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    Ld, Te = cfg.num_layers, cfg.encoder_seq

    def zeros(T):
        return torch.zeros((Ld, batch, T, KV, hd), dtype=dt, device=dev)
    return {"k": zeros(max_len), "v": zeros(max_len), "ck": zeros(Te),
            "cv": zeros(Te), "pos": 0}


def encdec_prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                   frames: torch.Tensor, attn_impl: str = "kernel"):
    """Encode the frames, precompute each layer's cross-KV, prefill the
    decoder's self-KV: (last-position logits (B, Vpad), cache).  For
    ``attn_impl="chunked"`` the encoder runs the einsum attention, as the
    reference's does, and the decoder's self-attention is chunked."""
    enc_out = encode(cfg, params, frames, "none",
                     "einsum" if attn_impl == "chunked" else attn_impl)
    x, (k, v, ck, cv) = _decoder(cfg, params, tokens, enc_out, "none",
                                 attn_impl, collect=True)
    logits = L.logits_from_hidden(x[:, -1:], params, False)[:, 0]
    return logits, {"k": k, "v": v, "ck": ck, "cv": cv,
                    "pos": tokens.shape[1]}


def encdec_decode(cfg: ModelConfig, params: dict, cache: dict,
                  tokens: torch.Tensor):
    """One decode step, tokens (B,1); the self-KV is written in place at
    slot ``pos``."""
    B, S1 = tokens.shape
    T = cache["k"].shape[2]
    pos = int(cache["pos"])
    if pos >= T:
        raise ValueError(f"decode at position {pos} but the cache holds "
                         f"{T} slots; grow it first")
    dev = tokens.device
    x = L.embed_tokens(params["embed"], tokens)
    x = x + _sinusoidal_at(pos, cfg.d_model, x.dtype, dev)[None, None]
    q_pos = torch.full((S1,), pos, dtype=torch.int32, device=dev)
    kv_pos = torch.arange(T, dtype=torch.int32, device=dev)
    kv_valid = (kv_pos <= pos)[None].expand(B, T)
    epos = torch.arange(cache["ck"].shape[2], dtype=torch.int32, device=dev)
    for i, p in enumerate(L.unstack_layers(params["dec_layers"], 1)):
        p = gather_weights(p)
        q, k_new, v_new = L.qkv_proj(L.rmsnorm(x, p["attn_norm"]), p["wq"],
                                     p["wk"], p["wv"])
        k_l, v_l = cache["k"][i], cache["v"][i]
        L.write_cache(k_l, k_new, pos)
        L.write_cache(v_l, v_new, pos)
        o = L.gqa_attention(q, k_l, v_l, q_pos=q_pos, kv_pos=kv_pos,
                            causal=True, kv_valid=kv_valid)
        x = L.carry(x + L.out_proj(o, p["wo"]))
        cq = sh.einsum("bsd,dnh->bsnh", L.rmsnorm(x, p["cross_norm"]),
                          p["cwq"])
        co = L.gqa_attention(cq, cache["ck"][i], cache["cv"][i], q_pos=q_pos,
                             kv_pos=epos, causal=False)
        x = L.carry(x + L.out_proj(co, p["cwo"]))
        x = L.carry(x + L.mlp(L.rmsnorm(x, p["mlp_norm"]), p, "gelu"))
    x = L.rmsnorm(x, params["dec_norm"])
    logits = L.logits_from_hidden(x, params, False)[:, 0]
    return logits, dict(cache, pos=pos + S1)
