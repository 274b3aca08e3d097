"""Decoder-only transformer family: dense (granite / starcoder2 / yi /
gemma3), MoE (qwen3-moe / olmoe) and VLM (the qwen2-vl text backbone with
a patch-embedding prefix and M-RoPE): the reference's
``repro.models.transformer`` in PyTorch.

Parameters keep the reference's stacked-by-layer layout (every tensor of
``params["layers"]`` leads with the layer axis), so a reference tree
carries across leaf for leaf (:func:`repro_torch.convert.tree_from_reference`);
the reference's ``scan`` over layers is a Python loop over that axis, and
its ``scan`` over experts a loop over the expert axis.
Heterogeneous attention (gemma3's 5 local : 1 global) is a per-layer
window: 0 for global layers, ``sliding_window`` for local ones.

Prefill attention runs the flash attention kernel (``layers.attention``)
where the positions' mask channel runs from 0, else the masked einsum
route (``layers.prefill_route``), or, for ``attn_impl="chunked"``, the
reference's chunked einsum attention; decode attends over the cache with
the plain einsum attention, and so does the training loss
(``decoder_loss``, the reference's default ``attn_impl="einsum"``).  The MoE block is the
reference's scan over all experts with top-k combine weights (serving
and the default loss) or, for ``moe_impl="ragged"``, its capacity-grouped
dispatch with GShard drops, in its one-device form; the expert products
are plain ``torch`` matmuls, as the reference leaves them to XLA.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch import device as _device
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import constraint, gather_weights
from repro_torch.launch import cost
from repro_torch.models import layers as L


def padded_vocab(cfg: ModelConfig) -> int:
    return cfg.padded_vocab


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


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
    if cfg.num_experts:
        E = cfg.num_experts
        layer["router"] = init((Lr, d, E), d)
        layer["we_gate"] = init((Lr, E, d, F), d)
        layer["we_up"] = init((Lr, E, d, F), d)
        layer["we_down"] = init((Lr, E, F, d), F)
    else:
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


def decoder_param_specs(cfg: ModelConfig) -> dict:
    """Logical-axis tree mirroring ``init_decoder`` output (the
    reference's, for :mod:`repro_torch.distributed.sharding`)."""
    layer = {
        "attn_norm": ("layers", None),
        "mlp_norm": ("layers", None),
        "wq": ("layers", "w_data", "heads", "head_dim"),
        "wk": ("layers", "w_data", "kv_heads", "head_dim"),
        "wv": ("layers", "w_data", "kv_heads", "head_dim"),
        "wo": ("layers", "heads", "head_dim", "w_data"),
    }
    if cfg.num_experts:
        layer.update({
            "router": ("layers", "w_data", None),
            "we_gate": ("layers", None, "w_data", "d_ff"),
            "we_up": ("layers", None, "w_data", "d_ff"),
            "we_down": ("layers", None, "d_ff", "w_data"),
        })
    else:
        if cfg.mlp_type == "swiglu":
            layer["w_gate"] = ("layers", "w_data", "d_ff")
        layer["w_up"] = ("layers", "w_data", "d_ff")
        layer["w_down"] = ("layers", "d_ff", "w_data")
    specs = {
        "embed": ("vocab", "embed_d"),
        "final_norm": (None,),
        "layers": layer,
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = ("embed_d", "vocab")
    return specs


def _layer(params: dict, i: int) -> dict:
    return {name: w[i] for name, w in params["layers"].items()}


# --------------------------------------------------------------------------
# Blocks
# --------------------------------------------------------------------------
def _router(x, router, K):
    """Top-``K`` experts of each token and their renormalised softmax
    weights, from float32 router logits: (weights, indices), (..., K)."""
    probs = torch.softmax(sh.matmul(x.float(), router.float()), dim=-1)
    top_w, top_i = torch.topk(probs, K, dim=-1)
    return top_w / top_w.sum(dim=-1, keepdim=True), top_i


def _moe_block(x: torch.Tensor, p: dict, cfg: ModelConfig) -> torch.Tensor:
    """Top-k MoE, the reference's baseline: every expert computed over
    every token, weighted by its combine weight (0 off the top k), summed
    in the model dtype in expert order."""
    top_w, top_i = _router(x, p["router"], cfg.num_experts_per_tok)
    if sh.is_distributed(x):      # the reference's one-hot sum
        experts = torch.arange(cfg.num_experts, device=x.device)
        combine = ((top_i[..., None] == experts).to(x.dtype)
                   * top_w.to(x.dtype)[..., None]).sum(dim=-2)
    else:
        combine = torch.zeros(x.shape[:-1] + (cfg.num_experts,),
                              dtype=x.dtype, device=x.device).scatter_(
            -1, top_i, top_w.to(x.dtype))
    acc = torch.zeros_like(x)
    for e in cost.steps(cfg.num_experts):
        h = F.silu(sh.matmul(x, p["we_gate"][e])) * sh.matmul(x,
                                                              p["we_up"][e])
        acc = acc + sh.matmul(h * combine[..., e, None], p["we_down"][e])
    return acc


MOE_CAPACITY_FACTOR = 2.0   # expert capacity = cf * TK/E (grouped MoE path)


def _moe_block_ragged(x: torch.Tensor, p: dict,
                      cfg: ModelConfig) -> torch.Tensor:
    """Top-k MoE by capacity-grouped dispatch (the reference's
    ``_moe_block_ragged``): the T*K (token, expert) rows sorted by expert
    with a stable sort (``jnp.argsort``'s), each expert's first ``cap``
    rows gathered into a dense (E, cap, d) block, rows past an expert's
    capacity dropped (GShard), the expert products in float32
    (``preferred_element_type``), the rows scattered back and combined.
    On a device mesh each device dispatches its own tokens, as in the
    reference's ``shard_map``, against the router and expert weights
    gathered over the FSDP axis (d whole) and split over the ``d_ff``
    one (:func:`_ragged_local`).  The reference keeps d split over
    ``data`` and sums the partial products over it, but ``data`` splits
    the tokens too, so each of its rows sums slices of different
    devices' tokens; the port gathers the weights, as it does for every
    other layer."""
    if not sh.is_distributed(x):
        return _ragged_local(x, p["router"], p["we_gate"], p["we_up"],
                             p["we_down"], cfg)
    x = constraint(x, "batch", None, None)    # exit SP once per block
    w = sh.gather_weights({k: p[k] for k in EXPERT})
    fn = sh.local_map(functools.partial(_ragged_local, cfg=cfg), (
        ("batch", None, None), (None, None), (None, None, "d_ff"),
        (None, None, "d_ff"), (None, "d_ff", None)),
        ("batch", None, None))
    return fn(x, w["router"], w["we_gate"], w["we_up"], w["we_down"])


def _ragged_local(x, router, we_gate, we_up, we_down, cfg):
    """The dispatch on one device's tokens (B, S, d) and its weight
    slices: router (d, E), gate / up (E, d, F_l), down (E, F_l, d).
    With no device mesh F_l = F and every reduction is the identity.
    Where the mesh splits F (``d_ff``), each device's expert products are
    its slice's part: the combined token outputs are all-reduced across
    those devices, and the gradients of the rows and of the combine
    weights, which each device holds a part of, are summed over them."""
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    B, S, d = x.shape
    T = B * S
    xf = x.reshape(T, d)
    logits = xf.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = torch.topk(probs, K, dim=-1)
    top_w = sh.sum_grad(top_w / top_w.sum(dim=-1, keepdim=True), "d_ff")
    flat_e = top_i.reshape(-1)
    TK = T * K
    order = torch.argsort(flat_e, stable=True)
    x_sorted = sh.sum_grad(xf[order // K], "d_ff")             # (TK, d)
    # bincount's length reads the data; E bins are known
    group_sizes = torch.zeros(E, dtype=flat_e.dtype,
                              device=x.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    cap = min(TK, int(-(-TK // E) * MOE_CAPACITY_FACTOR))
    starts = torch.cumsum(group_sizes, 0) - group_sizes
    slot = torch.arange(cap, device=x.device)
    valid = slot[None, :] < group_sizes[:, None]                 # (E, cap)
    rows = torch.where(valid, starts[:, None] + slot[None, :], TK)
    x_grp = torch.cat([x_sorted, x_sorted.new_zeros((1, d))])[rows]
    g = torch.bmm(x_grp.float(), we_gate.float())
    u = torch.bmm(x_grp.float(), we_up.float())
    h = (F.silu(g) * u).to(x.dtype)                            # (E,cap,F_l)
    o = torch.bmm(h.float(), we_down.float())                  # (E,cap,d)
    o_sorted = torch.zeros((TK + 1, d), dtype=o.dtype,
                           device=x.device).index_add_(
        0, rows.reshape(-1), o.reshape(-1, d) * valid.reshape(-1, 1))
    o_tok = torch.einsum("tkd,tk->td",
                         o_sorted[:TK][torch.argsort(order)].reshape(
                             T, K, d), top_w.to(o.dtype))
    # every device of the d_ff axis goes on with the same sum
    o_tok = sh.all_reduce(o_tok, "sum", "d_ff", grad="same")
    return o_tok.reshape(B, S, d).to(x.dtype)


#: the MoE block's routes: the scan over all experts, or the dispatch
MOE_IMPLS = ("scan", "ragged")
#: the MoE block's weights
EXPERT = ("router", "we_gate", "we_up", "we_down")


def _attn_block(x, p, cos, sin, positions, window, impl):
    """Prefill self-attention of one layer: (output, k, v)."""
    q, k, v = L.qkv_proj(x, p["wq"], p["wk"], p["wv"])
    q = L.apply_rope(q, cos, sin)
    k = L.apply_rope(k, cos, sin)
    o = L.attention(q, k, v, q_pos=positions, kv_pos=positions, causal=True,
                    window=window, impl=impl)
    return L.out_proj(o, p["wo"]), k, v


def _ffn(x, p, cfg, moe_impl: str = "scan"):
    """The feed-forward block: the MoE by ``moe_impl``, or the dense MLP."""
    if cfg.num_experts:
        if moe_impl == "ragged":
            return _moe_block_ragged(x, p, cfg)
        if moe_impl != "scan":
            raise ValueError(f"moe_impl {moe_impl!r} not in {MOE_IMPLS}")
        return _moe_block(x, p, cfg)
    return L.mlp(x, p, cfg.mlp_type)


def _rope(cfg: ModelConfig, positions: torch.Tensor):
    sections = cfg.mrope_sections if cfg.mrope else None
    return L.rope_cos_sin(positions, cfg.resolved_head_dim, cfg.rope_theta,
                          sections)


# --------------------------------------------------------------------------
# Forward (prefill hidden states)
# --------------------------------------------------------------------------
def default_positions(tokens: torch.Tensor) -> torch.Tensor:
    """(B, S) positions 0..S-1, each row alike."""
    B, S = tokens.shape
    return torch.arange(S, dtype=torch.int32,
                        device=tokens.device)[None].expand(B, S)


def mask_channel(positions: torch.Tensor) -> torch.Tensor:
    """The (S,) positions that mask attention, as the reference takes
    them: batch row 0 of (B, S) positions, or of the temporal channel of
    M-RoPE's (3, B, S)."""
    return positions[0] if positions.dim() == 2 else positions[0, 0]


def decoder_hidden(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
                   positions: torch.Tensor | None = None,
                   vision_embeds: torch.Tensor | None = None,
                   attn_impl: str = "kernel", remat_policy: str = "none",
                   moe_impl: str = "scan", collect_kv: bool = False):
    """tokens (B,S) -> hidden (B,S,D); optionally per-layer (k, v) stacks
    (L, B, S, KV, hd).  ``positions``: (B, S), or (3, B, S) for M-RoPE
    (default ``arange``); ``vision_embeds`` (B, V, D) replace the first V
    token embeddings (the VLM's patch-embedding prefix).  A prefill whose
    mask channel is not ``arange`` takes the masked attention route
    (``layers.prefill_route``).  ``remat_policy`` ``"full"`` or ``"dots"``
    wraps each layer in ``torch.utils.checkpoint`` (non-reentrant), as the
    reference wraps its layer body in ``jax.checkpoint``; values are the
    same (there is no counterpart of the ``dots`` save policy: the whole
    layer is recomputed)."""
    if positions is None:        # arange: its route needs no read
        positions = default_positions(tokens)
        impl = attn_impl
    else:
        impl = L.prefill_route(attn_impl, mask_channel(positions))
    cos, sin = _rope(cfg, positions)
    x = L.embed_tokens(params["embed"], tokens)
    if vision_embeds is not None:
        x = torch.cat([vision_embeds.to(x.dtype),
                       x[:, vision_embeds.shape[1]:]], dim=1)
    x = constraint(x, "batch", "act_seq", None)
    q_pos = mask_channel(positions)

    def body(h, p, window):
        # Megatron-SP block boundary (the reference's): the sequence
        # gathered before the projections, so the heads / d_ff split
        # applies inside; the outputs scattered back to sequence shards.
        # Both are no-ops where act_seq is not mapped.
        # the ragged MoE reads its weights split (the reference's
        # shard_map), every other weight is gathered (FSDP)
        p = dict(gather_weights({k: w for k, w in p.items()
                                 if moe_impl != "ragged" or k not in EXPERT}),
                 **{k: p[k] for k in EXPERT if moe_impl == "ragged"})
        attn_in = constraint(L.rmsnorm(h, p["attn_norm"]),
                             "batch", None, None)
        attn_out, k, v = _attn_block(attn_in, p, cos, sin, q_pos, window,
                                     impl)
        h = h + constraint(attn_out, "batch", "act_seq", None)
        mlp_in = constraint(L.rmsnorm(h, p["mlp_norm"]), "batch", None, None)
        return h + constraint(_ffn(mlp_in, p, cfg, moe_impl),
                              "batch", "act_seq", None), k, v

    ks, vs = [], []
    for p, window in zip(L.unstack_layers(params["layers"], 1),
                         layer_windows(cfg)):
        if remat_policy == "none":
            x, k, v = body(x, p, window)
        else:
            x, k, v = torch.utils.checkpoint.checkpoint(
                body, x, p, window, use_reentrant=False)
        if collect_kv:        # in the cache's layout (the reference's
            # prefill out_shardings)
            ks.append(constraint(k, "batch", "kv_seq", "kv_heads",
                                 "head_dim"))
            vs.append(constraint(v, "batch", "kv_seq", "kv_heads",
                                 "head_dim"))
    x = L.rmsnorm(x, params["final_norm"])
    if collect_kv:
        return x, (torch.stack(ks), torch.stack(vs))
    return x


def decoder_logits(cfg: ModelConfig, params: dict,
                   hidden: torch.Tensor) -> torch.Tensor:
    """(B,S,D) -> (B,S,Vpad) float32 logits."""
    return L.logits_from_hidden(hidden, params, cfg.tie_embeddings)


def decoder_loss(cfg: ModelConfig, params: dict, batch: dict, *,
                 attn_impl: str = "einsum", remat_policy: str = "dots",
                 loss_chunk: int = 0, moe_impl: str = "scan"
                 ) -> torch.Tensor:
    """Mean next-token NLL of ``batch["tokens"]`` against
    ``batch["labels"]`` (labels < 0 masked), with the batch's
    ``positions`` and ``vision_embeds`` where it has them; attention by
    ``attn_impl`` (``"einsum"`` or ``"chunked"``: no kernel has a
    backward).  With ``loss_chunk`` dividing the sequence, the logits
    are formed ``loss_chunk`` positions at a time, never all (B,S,V) at
    once."""
    hidden = decoder_hidden(cfg, params, batch["tokens"],
                            positions=batch.get("positions"),
                            vision_embeds=batch.get("vision_embeds"),
                            attn_impl=attn_impl, remat_policy=remat_policy,
                            moe_impl=moe_impl)
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
    dev = _device.resolve(device)
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=_dtype(cfg), device=dev),
            "v": torch.zeros(shape, dtype=_dtype(cfg), device=dev),
            "pos": 0}


def cache_specs(cfg: ModelConfig) -> dict:
    return {"k": ("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
            "v": ("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
            "pos": ()}


def grow_cache(cache: dict, max_len: int) -> dict:
    """The cache with the time axis of its self-attention ``k`` / ``v``
    zero-padded to ``max_len`` slots (what the reference's serve driver
    does with ``jnp.pad`` after a prefill; any family's cache that holds
    them: the transformer's, hymba's, the encoder-decoder's)."""
    pad = max_len - cache["k"].shape[2]
    if pad < 0:
        raise ValueError(f"cache holds {cache['k'].shape[2]} slots, more "
                         f"than {max_len}")

    def grow(t):
        return torch.cat([t, t.new_zeros(t.shape[:2] + (pad,)
                                         + t.shape[3:])], dim=2)
    return dict(cache, k=grow(cache["k"]), v=grow(cache["v"]))


def decoder_prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
                    positions: torch.Tensor | None = None,
                    vision_embeds: torch.Tensor | None = None,
                    attn_impl: str = "kernel"):
    """Full-sequence forward that also returns the populated KV cache and the
    last-position logits (the realistic serve entry point)."""
    hidden, (k, v) = decoder_hidden(cfg, params, tokens, positions=positions,
                                    vision_embeds=vision_embeds,
                                    attn_impl=attn_impl, collect_kv=True)
    cache = {"k": k, "v": v, "pos": tokens.shape[1]}
    logits = L.logits_from_hidden(hidden[:, -1:], params,
                                  cfg.tie_embeddings)
    return logits[:, 0], cache


def decoder_decode(cfg: ModelConfig, params: dict, cache: dict,
                   tokens: torch.Tensor, *,
                   positions: torch.Tensor | None = None):
    """One decode step. tokens (B,1); cache KV (L,B,T,KV,hd); ``positions``
    (B,1) or M-RoPE's (3,B,1) for the rotary angles (default: the cache
    position); returns (logits (B,Vpad), new cache).  The cache tensors
    are written in place at slot ``pos`` (the reference returns updated
    copies)."""
    B, S1 = tokens.shape
    T = cache["k"].shape[2]
    pos = int(cache["pos"])
    if pos >= T:
        raise ValueError(f"decode at position {pos} but the cache holds "
                         f"{T} slots; grow it first")
    dev = tokens.device
    if positions is None:
        positions = torch.full((B, S1), pos, dtype=torch.int32, device=dev)
    cos, sin = _rope(cfg, positions)
    x = L.embed_tokens(params["embed"], tokens)
    q_pos = torch.full((S1,), pos, dtype=torch.int32, device=dev)
    kv_pos = torch.arange(T, dtype=torch.int32, device=dev)
    kv_valid = (kv_pos <= pos)[None].expand(B, T)
    for i, window in enumerate(layer_windows(cfg)):
        p = gather_weights(_layer(params, i))
        attn_in = L.rmsnorm(x, p["attn_norm"])
        q, k_new, v_new = L.qkv_proj(attn_in, p["wq"], p["wk"], p["wv"])
        q = L.apply_rope(q, cos, sin)
        k_new = L.apply_rope(k_new, cos, sin)
        k_l, v_l = cache["k"][i], cache["v"][i]
        L.write_cache(k_l, k_new, pos)
        L.write_cache(v_l, v_new, pos)
        o = L.attention(q, k_l, v_l, q_pos=q_pos, kv_pos=kv_pos, causal=True,
                        window=window, kv_valid=kv_valid)
        x = L.carry(x + L.out_proj(o, p["wo"]))
        x = L.carry(x + _ffn(L.rmsnorm(x, p["mlp_norm"]), p, cfg))
    x = L.rmsnorm(x, params["final_norm"])
    logits = L.logits_from_hidden(x, params, cfg.tie_embeddings)
    return logits[:, 0], dict(cache, pos=pos + S1)
