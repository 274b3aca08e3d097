"""Shared model building blocks: norms, RoPE / M-RoPE, GQA attention,
MLPs, embeddings (the reference's ``repro.models.layers``, in PyTorch).

Conventions, as in the reference:
 * activations (B, S, D); queries (B, S, H, hd); keys/values (B, T, KV, hd);
 * masks are built from position vectors;
 * softmax and normalization in float32, matmuls in the model dtype; where
   the reference asks for float32 results (``preferred_element_type``) the
   operands are cast to float32 first.

Serving's prefill attention (no ``kv_valid``) goes through the flash
attention kernel's front door for any sequence length, causal or not,
and for cross-attention (queries and keys of other lengths).  The
kernel masks by index from 0, so a prefill whose mask channel is not
``arange`` (a VLM's position ids may start elsewhere) takes the masked
route instead (:func:`prefill_route`).  ``impl="chunked"`` is the
reference's own prefill route (its default, and its dry-run's):
:func:`chunked_attention`, the einsum attention a block of queries at a
time, masked by the positions.  The decode step (``kv_valid`` given)
and training (``impl="einsum"``, the reference's default for a loss:
the kernel has no backward) run the plain einsum attention.  The
reference's sharding constraints sit where the reference has them and
resolve through :mod:`repro_torch.distributed.sharding`: on one card
``constraint`` is the identity; on a device mesh it redistributes.
Where the mesh splits the vocabulary, the embedding and the loss read
each device's own rows / columns of the table and the logits and reduce
across the vocabulary shards (a gather along a vocab-sharded axis would
gather the table or the logits; the reference contracts a one-hot
instead).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import constraint, splits
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.launch import cost


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------
def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * scale.float()
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# RoPE / M-RoPE
# --------------------------------------------------------------------------
def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                 sections: Optional[tuple] = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """positions: (B, S) integer, or (C, B, S) for M-RoPE with C position
    channels (temporal / height / width) -> cos/sin (B, S, hd/2) in
    float32.

    M-RoPE (Qwen2-VL): frequency slot i takes its position from channel
    ``section_id(i)``, ``sections`` giving each channel's slot count.  A
    channel past the last of ``positions`` reads the last (the reference's
    gather clamps its index the same way), so (B, S) positions give every
    channel the same ones."""
    half = head_dim // 2
    idx = torch.arange(half, dtype=torch.float32, device=positions.device)
    freq = theta ** (-idx * 2.0 / head_dim)
    if sections is None:
        angles = positions.float()[..., None] * freq
        return torch.cos(angles), torch.sin(angles)
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {sections} do not sum to "
                         f"head_dim / 2 = {half}")
    pos = positions if positions.dim() == 3 else positions[None]
    sec_ids = torch.tensor([min(c, pos.shape[0] - 1)
                            for c, n in enumerate(sections) for _ in range(n)],
                           device=pos.device)
    angles = pos[sec_ids].permute(1, 2, 0).float() * freq   # (B, S, half)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, ..., hd); cos/sin: (B, S, hd/2) broadcast over head dims."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    shape = cos.shape[:2] + (1,) * (x.dim() - 3) + cos.shape[2:]
    c, s = cos.reshape(shape), sin.reshape(shape)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# --------------------------------------------------------------------------
# Attention
# --------------------------------------------------------------------------
NEG_INF = -1e30


def _band_bias(q_pos: torch.Tensor, kv_pos: torch.Tensor, causal: bool,
               window: int) -> torch.Tensor:
    """Additive bias (..., Sq, Tk) from positions; ``window`` 0 = global."""
    q = q_pos[..., :, None].long()
    k = kv_pos[..., None, :].long()
    ok = torch.ones(torch.broadcast_shapes(q.shape, k.shape),
                    dtype=torch.bool, device=q.device)
    if causal:
        ok = ok & (k <= q)
    if window > 0:
        ok = ok & (q - k < window)
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    return torch.where(ok, zero, NEG_INF)


def repeat_kv(k: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B,T,KV,hd) -> (B,T,H,hd), each KV head repeated for its group."""
    B, T, KV, hd = k.shape
    if KV == num_heads:
        return k
    G = num_heads // KV
    return k[:, :, :, None, :].expand(B, T, KV, G, hd).reshape(
        B, T, num_heads, hd)


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  q_pos: torch.Tensor, kv_pos: torch.Tensor,
                  causal: bool = True, window: int = 0,
                  kv_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Einsum attention. q: (B,S,H,hd), k/v: (B,T,KV,hd) -> (B,S,H,hd).

    ``kv_valid``: optional (B, T) bool marking populated cache slots
    (decode). Softmax in f32.  On a device mesh:
    :func:`_attention_on_mesh`.
    """
    if sh.is_distributed(q):
        return _attention_on_mesh(q, k, v, q_pos=q_pos, kv_pos=kv_pos,
                                  causal=causal, window=window,
                                  kv_valid=kv_valid, impl="einsum",
                                  chunk=q.shape[1])
    H = q.shape[2]
    k = repeat_kv(k, H)
    v = repeat_kv(v, H)
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    bias = _band_bias(q_pos, kv_pos, causal, window)     # (S, T) or (B,S,T)
    if bias.dim() == 3:
        bias = bias[:, None]
    scores = scores + bias
    if kv_valid is not None:
        scores = torch.where(kv_valid[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", probs.to(v.dtype).float(),
                       v.float())
    return out.to(v.dtype)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      q_pos: torch.Tensor, kv_pos: torch.Tensor,
                      causal: bool = True, window: int = 0,
                      chunk: int = 512) -> torch.Tensor:
    """Memory-efficient attention: the queries and their positions cut
    into ``S // chunk`` chunks, each through :func:`gqa_attention`
    against all keys, so one chunk's (chunk, T) scores are alive at a
    time instead of the (S, T) ones.  Without autograd each chunk writes
    its rows of an output made up front, and under a
    :class:`~repro_torch.launch.cost.Tally` the loop is traced three
    chunks deep (:func:`~repro_torch.launch.cost.steps`).  With autograd
    the chunks' outputs are concatenated and every chunk is traced: a
    loop traced in part would hold the untraced chunks' outputs until
    the backward, where the concatenation frees them, and a checkpoint's
    recompute would free their saved tensors before it."""
    B, S, H, hd = q.shape
    if S % chunk:
        raise ValueError(f"{S} queries do not split into chunks of {chunk}")
    nq = S // chunk

    def one_chunk(i):
        rows = slice(i * chunk, (i + 1) * chunk)
        return gqa_attention(q[:, rows], k, v, q_pos=q_pos[..., rows],
                             kv_pos=kv_pos, causal=causal, window=window)

    if torch.is_grad_enabled():
        return torch.cat([one_chunk(i) for i in range(nq)], dim=1)
    out = q.new_empty((B, S, H, hd), dtype=v.dtype)
    for i in cost.steps(nq):
        out[:, i * chunk:(i + 1) * chunk] = one_chunk(i)
    return out


#: attention routes without a cache: the flash attention kernel's front
#: door, or its plain version (``chip_smoke.py`` holds the one against the
#: other), for a prefill whose positions run from 0; the masked route (the
#: einsum attention, masking by the positions themselves) for a prefill
#: whose positions do not (:func:`prefill_route`); the reference's chunked
#: einsum attention (:func:`chunked_attention`), which masks by the
#: positions too; the einsum attention for training
PREFILL_IMPLS = ("kernel", "plain", "masked", "chunked", "einsum")
MASKED = "masked"


def positions_from_zero(pos: torch.Tensor) -> bool:
    """Whether a mask channel (S,) is ``arange(S)``, the positions the
    flash attention kernel masks by (one read of the tensor: on the card
    a wait for it)."""
    return bool(torch.equal(pos, torch.arange(
        pos.shape[-1], dtype=pos.dtype, device=pos.device)))


def prefill_route(impl: str, q_pos: torch.Tensor) -> str:
    """The route of a prefill's attention whose mask channel is ``q_pos``
    (the keys' too): ``impl`` where the positions are ``arange`` (every
    driver of the repo), else :data:`MASKED`.  A semantic route, taken
    before any launch: the kernel cannot mask by other positions.  The
    routes that mask by the positions (``"chunked"``, ``"masked"``,
    ``"einsum"``) are kept without reading them."""
    if impl in ("kernel", "plain") and not positions_from_zero(q_pos):
        return MASKED
    return impl


def _decode_combine(q, k, v, kv_valid, kv_pos, *, q_pos, causal, window):
    """One device's decode attention over its shard of a cache whose
    sequence the mesh splits (``kv_seq``): q (B,1,H,hd) with every head,
    k/v (B,T_l,H,hd); the softmax's max and sum and the weighted values
    reduced across the shards (the online-softmax combine)."""
    scores = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * \
        q.shape[-1] ** -0.5
    scores = scores + _band_bias(q_pos, kv_pos, causal, window)
    scores = torch.where(kv_valid[:, None, None, :], scores, NEG_INF)
    m = sh.all_reduce(scores.amax(dim=-1, keepdim=True), "max", "kv_seq")
    p = torch.exp(scores - m)
    den = sh.all_reduce(p.sum(dim=-1), "sum", "kv_seq")          # (B,H,S)
    out = sh.all_reduce(torch.einsum("bhst,bthd->bshd", p.to(v.dtype).float(),
                                     v.float()), "sum", "kv_seq")
    return (out / den.transpose(1, 2)[..., None]).to(v.dtype)


def _attention_on_mesh(q, k, v, *, q_pos, kv_pos, causal, window, kv_valid,
                       impl, chunk):
    """:func:`attention` on a device mesh: each device attends over its
    batch rows and heads (keys and values repeated to the query heads
    first), or, decoding over a cache whose sequence the mesh splits,
    over its shard of the cache for every head (:func:`_decode_combine`).
    DTensor would gather the heads where an einsum flattens them into
    its batch."""
    H = q.shape[2]
    k, v = repeat_kv(k, H), repeat_kv(v, H)
    # positions read from a laid-out batch (M-RoPE's) whole on each device
    q_pos, kv_pos = (constraint(t, *(None,) * t.dim()).to_local()
                     if sh.is_distributed(t) else t for t in (q_pos, kv_pos))
    if kv_valid is not None and splits("kv_seq"):
        fn = functools.partial(_decode_combine, q_pos=q_pos, causal=causal,
                               window=window)
        full, shard = ("batch", None, None, None), ("batch", "kv_seq", None,
                                                    None)
        return sh.local_map(fn, (full, shard, shard, ("batch", "kv_seq"),
                                 ("kv_seq",)), full)(q, k, v, kv_valid,
                                                     kv_pos)
    heads = ("batch", None, "heads", None)

    def fn(q, k, v, kv_valid):
        return attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos, causal=causal,
                         window=window, kv_valid=kv_valid, impl=impl,
                         chunk=chunk)
    return sh.local_map(fn, (heads, heads, heads, ("batch", None)), heads)(
        q, k, v, kv_valid)


def attention(q, k, v, *, q_pos, kv_pos, causal=True, window=0,
              kv_valid=None, impl: str = "kernel", chunk: int = 512):
    """Prefill (``kv_valid is None``), ``impl`` ``"kernel"`` or
    ``"plain"``: flash attention, which masks by index from 0 (the caller
    has checked that ``q_pos`` / ``kv_pos`` are ``arange``, see
    :func:`prefill_route`); queries and keys may differ in length.
    ``impl="chunked"``: :func:`chunked_attention` where there are more
    than ``chunk`` queries and no ``kv_valid``, as the reference chunks.
    Decode, ``impl="masked"``, ``"einsum"`` and ``"chunked"`` otherwise:
    einsum attention, masked by the positions (over the populated cache,
    for decode).  On a device mesh: :func:`_attention_on_mesh`."""
    if sh.is_distributed(q):
        return _attention_on_mesh(q, k, v, q_pos=q_pos, kv_pos=kv_pos,
                                  causal=causal, window=window,
                                  kv_valid=kv_valid, impl=impl, chunk=chunk)
    if kv_valid is None and impl in ("kernel", "plain"):
        fn = flash_ops if impl == "kernel" else flash_ref
        return fn.flash_attention(q, k, v, causal=causal, window=window)
    if impl not in PREFILL_IMPLS:
        raise ValueError(f"attention impl {impl!r} not in {PREFILL_IMPLS}")
    if impl == "chunked" and q.shape[1] > chunk and kv_valid is None:
        return chunked_attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos,
                                 causal=causal, window=window, chunk=chunk)
    return gqa_attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos, causal=causal,
                         window=window, kv_valid=kv_valid)


def write_cache(buf: torch.Tensor, new: torch.Tensor, pos: int) -> None:
    """``buf[:, pos:pos + S] = new`` in place: a layer's cache (B,T,...)
    and the step's (B,S,...) entries.  On a device mesh, ``new`` laid out
    as the cache and written by the device whose shard of the cache's
    sequence (``kv_seq``) holds the slots, as XLA's partitioner lowers
    the reference's ``dynamic_update_slice``."""
    S = new.shape[1]
    if not sh.is_distributed(buf):
        buf[:, pos:pos + S] = new
        return
    axes = ("batch", None) + (("kv_heads", "head_dim") if buf.dim() == 4
                              else (None,) * (buf.dim() - 2))
    new = constraint(new, *axes).to_local()
    loc = buf.to_local()
    start = sh.mesh_coordinate("kv_seq")[0] * loc.shape[1] \
        if splits("kv_seq") else 0
    lo, hi = max(pos, start), min(pos + S, start + loc.shape[1])
    if lo < hi:
        loc[:, lo - start:hi - start] = new[:, lo - pos:hi - pos]


def carry(x: torch.Tensor) -> torch.Tensor:
    """The residual stream between layers in its layout, (batch, act_seq,
    None), as the reference's layer scan keeps its carry's: a layer's
    partial sums are reduced into it, never left for DTensor to place."""
    return constraint(x, "batch", "act_seq", None)


# --------------------------------------------------------------------------
# Projections / MLP
# --------------------------------------------------------------------------
def _kv_heads_layout(w):
    """A key / value projection (D, KV, hd) laid out over the mesh axes
    of the query heads where those axes split the KV heads evenly (a
    slice of the replicated weight): each device projects only the KV
    heads its query heads read, as XLA's partitioner propagates the
    heads' split back through the grouped repeat.  Else ``w``."""
    ways = sh.mesh_coordinate("heads")[1]
    if ways == 1 or w.shape[1] % ways:
        return w
    from torch.distributed.tensor import Shard
    pl = list(w.placements)
    for d in sh.mesh_axes("heads"):
        pl[d] = Shard(1)
    return w.redistribute(w.device_mesh, pl)


def qkv_proj(x, wq, wk, wv):
    """x: (B,S,D) -> q (B,S,H,hd), k/v (B,S,KV,hd)."""
    if sh.is_distributed(wk):
        wk, wv = _kv_heads_layout(wk), _kv_heads_layout(wv)
    q = sh.einsum("bsd,dnh->bsnh", x, wq)
    k = sh.einsum("bsd,dkh->bskh", x, wk)
    v = sh.einsum("bsd,dkh->bskh", x, wv)
    return q, k, v


def out_proj(o, wo):
    """o: (B,S,H,hd), wo: (H, hd, D) -> (B,S,D)."""
    return sh.einsum("bsnh,nhd->bsd", o, wo)


def mlp(x, params: dict, mlp_type: str):
    if mlp_type == "swiglu":
        gate = sh.matmul(x, params["w_gate"])
        up = sh.matmul(x, params["w_up"])
        h = F.silu(gate) * up
    else:
        h = F.gelu(sh.matmul(x, params["w_up"]),
                   approximate="tanh")                    # jax.nn.gelu
    h = constraint(h, "batch", None, "d_ff")
    return sh.matmul(h, params["w_down"])


# --------------------------------------------------------------------------
# Embedding / logits
# --------------------------------------------------------------------------
def embed_tokens(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The rows of ``embed`` at ``tokens``; where the mesh splits the
    vocabulary, :func:`_vocab_parallel_embed`, not a gather of the
    table."""
    if splits("vocab"):
        return _vocab_parallel_embed(embed, tokens)
    return embed[tokens]


def _vocab_parallel_embed(embed: torch.Tensor,
                          tokens: torch.Tensor) -> torch.Tensor:
    """The lookup of a table whose rows the mesh splits: each device
    reads the tokens that fall in its rows (zeros elsewhere), and the
    partial sums are all-reduced across the vocabulary shards."""
    from torch.distributed.tensor import DTensor, Partial
    table = sh.shard_of(constraint(embed, "vocab", None))   # FSDP gather
    tok = constraint(tokens, "batch", None).to_local().long()
    start = sh.mesh_coordinate("vocab")[0] * table.shape[0]
    ids = tok - start
    inside = (ids >= 0) & (ids < table.shape[0])
    out = F.embedding(ids.clamp(0, table.shape[0] - 1), table) * \
        inside[..., None].to(table.dtype)
    pl = sh.placements(sh.logical_spec("batch", None, None),
                       sh.active_mesh())
    for d in sh.mesh_axes("vocab"):
        pl[d] = Partial()
    out = DTensor.from_local(out, sh.active_device_mesh(), pl,
                             run_check=False)
    return constraint(out, "batch", None, None)


def logits_from_hidden(x, params, tie: bool):
    """(B,S,D) -> (B,S,Vpad) float32 logits.  On a mesh the hidden states
    leave any sequence-parallel region first, and the logits keep the
    vocab-parallel layout (the reference's constraints)."""
    x = constraint(x, "batch", None, None)
    if tie:
        out = sh.matmul(x.float(),
                        sh.gather_weights(params["embed"]).float().T)
    else:
        out = sh.matmul(x.float(),
                        sh.gather_weights(params["unembed"]).float())
    return constraint(out, "batch", None, "vocab")


def _gold_logit(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits[b, s, labels[b, s]] (labels < 0 read class 0; they are
    masked by the caller)."""
    lab = torch.clamp(labels, min=0).long()
    return torch.gather(logits, -1, lab[..., None])[..., 0]


def _vocab_parallel_nll(logits: torch.Tensor,
                        labels: torch.Tensor) -> torch.Tensor:
    """One device's part of :func:`cross_entropy` over its batch rows and
    its columns of the vocabulary: the log-sum-exp's max and sum and the
    gold logit (read where the label falls in the device's columns) are
    reduced across the vocabulary shards, the NLL and the token count
    across the batch shards, so no full-vocabulary row is made.  Every
    device ends with the same loss, so each reduction's gradient passes
    through (``grad="same"``)."""
    m = sh.all_reduce(logits.amax(dim=-1, keepdim=True).detach(), "max",
                      "vocab")
    lse = (m + torch.log(sh.all_reduce(
        torch.sum(torch.exp(logits - m), dim=-1, keepdim=True), "sum",
        "vocab", grad="same")))[..., 0]
    ids = torch.clamp(labels, min=0).long() - \
        sh.mesh_coordinate("vocab")[0] * logits.shape[-1]
    inside = (ids >= 0) & (ids < logits.shape[-1])
    gold = torch.gather(logits, -1, ids.clamp(0, logits.shape[-1] - 1)
                        [..., None])[..., 0]
    gold = sh.all_reduce(gold * inside.to(gold.dtype), "sum", "vocab",
                         grad="same")
    mask = (labels >= 0).float()
    total = sh.all_reduce(torch.sum((lse - gold) * mask), "sum", "batch",
                          grad="same")
    count = sh.all_reduce(torch.sum(mask), "sum", "batch")
    return total / torch.clamp(count, min=1.0)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """Mean token NLL in float32; labels < 0 are masked (the chunked form
    is ``transformer.decoder_loss``'s).  Where the mesh splits the
    vocabulary, on each device's shards (:func:`_vocab_parallel_nll`)."""
    logits = logits.float()
    if splits("vocab"):
        rows = ("batch",) + (None,) * (labels.dim() - 1)
        return sh.local_map(_vocab_parallel_nll, (rows + ("vocab",), rows),
                            ())(logits, labels)
    lse = torch.logsumexp(logits, dim=-1)
    nll = lse - _gold_logit(logits, labels)
    mask = (labels >= 0).float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


# --------------------------------------------------------------------------
# Stacked layers
# --------------------------------------------------------------------------
def unstack_layers(tree: dict, lead: int) -> list[dict]:
    """Per-layer dicts of views of stacked tensors whose first ``lead``
    axes index the layer, taken with one ``unbind`` each, so a backward
    pass stacks the layer gradients once instead of summing a full-size
    gradient a layer."""
    names = list(tree)
    return [dict(zip(names, ws)) for ws in zip(
        *(tree[n].flatten(0, lead - 1).unbind(0) for n in names))]


# --------------------------------------------------------------------------
# Init helpers
# --------------------------------------------------------------------------
def dense_init(gen: torch.Generator, shape, dtype, fan_in: Optional[int] = None,
               device=None) -> torch.Tensor:
    """Normal(0, 1) * fan_in^-0.5, drawn in float32 then cast, like the
    reference's ``dense_init`` (the numbers differ: another generator).
    Drawn slice by slice along the leading axis, so a stacked-by-layer
    tensor never needs a float32 copy of itself."""
    fan = fan_in if fan_in is not None else shape[0]
    std = fan ** -0.5
    out = torch.empty(shape, dtype=dtype, device=device)
    rows = out.reshape(shape[0], -1) if len(shape) > 2 else out.reshape(1, -1)
    for row in rows:
        row.copy_(torch.randn(row.shape, generator=gen, dtype=torch.float32,
                              device=device) * std)
    return out
