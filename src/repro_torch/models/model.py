"""Unified model API, the reference's ``repro.models.model`` in PyTorch:

  init(cfg, gen, device)        -> params tree (the reference's layout)
  loss_fn(cfg, ...)             -> callable(params, batch) -> scalar
  make_train_step(cfg, opt)     -> callable(state, batch) -> (state, metrics)
  init_train_state(cfg, opt, gen, device) -> TrainState
  init_cache(cfg, batch, max_len, device) -> per-family serve state
  make_prefill_step(cfg)        -> callable(params, batch) -> (logits, cache)
  make_decode_step(cfg)         -> callable(params, cache, tokens) -> (logits, cache)
  param_specs / cache_specs / batch_specs / train_state_specs
                                -> logical-axis trees (the reference's)
  abstract_params / abstract_train_state / input_specs
                                -> the same trees of ``meta`` tensors

Every family of the reference: ``dense``, ``moe`` and ``vlm``
(transformer), ``encdec`` (whisper), ``ssm`` (xLSTM) and ``hybrid``
(hymba).  Prefill runs the hand-written kernels (flash attention,
chunkwise mLSTM); ``attn_impl="plain"`` runs their plain versions
instead, and ``attn_impl="chunked"`` the reference's own prefill route
(its chunked einsum attention; the xLSTM's plain mLSTM).  Prefill pads nothing: a cache comes back with the prompt's
length, and the caller grows it (``transformer.grow_cache``) before
decoding past it.  The loss runs what the reference's loss runs (einsum
attention, ``mlstm_chunked``, the MoE by ``moe_impl``) under
``torch.autograd``; no kernel sits on it.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.distributed import sharding as sh
from repro_torch.launch import cost
from repro_torch.models import encdec as E
from repro_torch.models import hymba as HY
from repro_torch.models import transformer as T
from repro_torch.models import xlstm as X
from repro_torch.optim import Optimizer, TrainState
from repro_torch.tree import rebuild, tree_leaves

TRANSFORMER_FAMILIES = ("dense", "moe", "vlm")


def _family(cfg: ModelConfig) -> str:
    """``"transformer"``, ``"encdec"``, ``"ssm"`` or ``"hybrid"``."""
    if cfg.family in TRANSFORMER_FAMILIES:
        return "transformer"
    if cfg.family in ("encdec", "ssm", "hybrid"):
        return cfg.family
    raise ValueError(f"unknown model family {cfg.family!r}")


def init(cfg: ModelConfig, gen: torch.Generator,
         device: _device.DeviceLike | None = None) -> dict:
    return {"transformer": T.init_decoder, "encdec": E.init_encdec,
            "ssm": X.init_xlstm, "hybrid": HY.init_hymba}[_family(cfg)](
        cfg, gen, device)


def param_specs(cfg: ModelConfig) -> dict:
    """Logical-axis tree mirroring :func:`init` output."""
    return {"transformer": T.decoder_param_specs,
            "encdec": E.encdec_param_specs, "ssm": X.xlstm_param_specs,
            "hybrid": HY.hymba_param_specs}[_family(cfg)](cfg)


def _abstract_gen() -> torch.Generator:
    """A generator for draws on ``meta``, which allocate nothing."""
    return torch.Generator().manual_seed(0)


def abstract_params(cfg: ModelConfig) -> dict:
    """The parameter tree on the ``meta`` device: shapes and dtypes,
    nothing allocated (the dry-run's stand-in)."""
    return init(cfg, _abstract_gen(), "meta")


# --------------------------------------------------------------------------
# loss / train step
# --------------------------------------------------------------------------
def loss_fn(cfg: ModelConfig, *, attn_impl: str = "einsum",
            remat_policy: str = "dots", loss_chunk: int = 0,
            moe_impl: str = "scan") -> Callable[[Any, dict], torch.Tensor]:
    """The training loss: attention by ``attn_impl`` (``"einsum"``, the
    reference's default, or ``"chunked"``), ``mlstm_chunked`` and the MoE
    by ``moe_impl`` (``"scan"`` or ``"ragged"``) under ``torch.autograd``,
    as the reference's loss (no kernel has a backward, so none sits on
    it).  ``loss_chunk`` and ``moe_impl`` reach the transformer families,
    ``attn_impl`` every family but the xLSTM, as in the reference."""
    family = _family(cfg)
    if family == "transformer":
        return functools.partial(T.decoder_loss, cfg, attn_impl=attn_impl,
                                 remat_policy=remat_policy,
                                 loss_chunk=loss_chunk, moe_impl=moe_impl)
    return functools.partial({"encdec": E.encdec_loss, "ssm": X.xlstm_loss,
                              "hybrid": HY.hymba_loss}[family], cfg,
                             attn_impl=attn_impl, remat_policy=remat_policy)


def batch_to(batch: dict, device: torch.device) -> dict:
    """A batch of numpy arrays (the data pipeline's) or tensors on
    ``device``; integer arrays (tokens, labels) become int64."""
    out = {}
    for key, val in batch.items():
        t = val if isinstance(val, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(val))
        if not t.is_floating_point():
            t = t.long()
        out[key] = t.to(device)
    return out


def value_and_grad(lf: Callable, params: Any, batch: dict
                   ) -> tuple[torch.Tensor, Any]:
    """``(lf(params, batch), d lf / d params)``, the gradient a tree
    shaped like ``params`` in the parameters' dtypes; on a device mesh
    each gradient laid out as its parameter (the gradient reduction)."""
    leaves = [leaf.detach().requires_grad_(True)
              for leaf in tree_leaves(params)]
    loss = lf(rebuild(params, iter(leaves)), batch)
    grads = [g if not sh.is_distributed(p) else
             g.redistribute(p.device_mesh, p.placements)
             for p, g in zip(leaves, torch.autograd.grad(loss, leaves))]
    return loss.detach(), rebuild(params, iter(grads))


def _split_local(val, axis: int, n: int):
    """A batch laid out on a device mesh cut into ``n`` microbatches
    along ``axis`` from each device's own rows (microbatch ``i`` is every
    device's ``i``-th block of rows), so no row moves; the reference
    reshapes the global batch and lets its partitioner move the rows
    (an all-to-all).  The gradient sums every row either way."""
    from torch.distributed.tensor import DTensor, Shard
    loc = val.to_local()
    if loc.shape[axis] % n:
        raise ValueError(f"{loc.shape[axis]} rows a device, which {n} "
                         f"microbatches do not divide")
    y = loc.reshape(loc.shape[:axis] + (n, loc.shape[axis] // n)
                    + loc.shape[axis + 1:])
    pl = [Shard(p.dim + 1) if p.is_shard() and p.dim >= axis else p
          for p in val.placements]
    return DTensor.from_local(y, val.device_mesh, pl, run_check=False)


def make_train_step(cfg: ModelConfig, opt: Optimizer,
                    train_cfg: Optional[TrainConfig] = None,
                    attn_impl: str = "einsum"):
    """``train_step(state, batch) -> (state, metrics)``: the loss (its
    attention by ``attn_impl``) and its gradient (accumulated over
    ``train_cfg.grad_accum`` microbatches in ``accum_dtype``, as the
    reference's scan does), then one optimizer update.  Metrics:
    ``loss``, ``grad_norm`` (before clipping), ``lr``, each a 0-d tensor.
    The batch goes to the parameters' device."""
    tc = train_cfg or TrainConfig()
    lf = loss_fn(cfg, attn_impl=attn_impl, remat_policy=tc.remat_policy,
                 loss_chunk=tc.loss_chunk, moe_impl=tc.moe_impl)

    def _split(key, val, n):
        """``val`` as ``n`` microbatches along a new leading axis, cut
        along the batch axis, which M-RoPE's (3, B, S) positions hold
        second."""
        axis = 1 if key == "positions" else 0
        if val.shape[axis] % n:
            raise ValueError(f"batch[{key!r}] holds {val.shape[axis]} "
                             f"rows, which {n} microbatches do not divide")
        if sh.is_distributed(val):
            y = _split_local(val, axis, n)
        else:
            y = val.reshape(val.shape[:axis] + (n, val.shape[axis] // n)
                            + val.shape[axis + 1:])
        return y.movedim(1, 0) if axis else y

    def _grads(params, batch):
        if tc.grad_accum <= 1:
            return value_and_grad(lf, params, batch)
        n = tc.grad_accum
        adt = getattr(torch, tc.accum_dtype)
        gsum = [torch.zeros_like(p, dtype=adt) for p in tree_leaves(params)]
        lsum = torch.zeros((), dtype=torch.float32)
        split = {key: _split(key, val, n) for key, val in batch.items()}
        for i in cost.steps(n, closed=True):
            micro = {key: val[i] for key, val in split.items()}
            loss, g = value_and_grad(lf, params, micro)
            gsum = [a + b.to(adt) for a, b in zip(gsum, tree_leaves(g))]
            lsum = lsum.to(loss.device) + loss
        return lsum / n, rebuild(params, iter([g / n for g in gsum]))

    def train_step(state: TrainState, batch: dict):
        dev = tree_leaves(state.params)[0].device
        loss, grads = _grads(state.params, batch_to(batch, dev))
        new_params, new_opt, om = opt.update(grads, state.opt_state,
                                             state.params, state.step)
        metrics = {"loss": loss, **om}
        return TrainState(state.step + 1, new_params, new_opt), metrics

    return train_step


def init_train_state(cfg: ModelConfig, opt: Optimizer, gen: torch.Generator,
                     device: _device.DeviceLike | None = None) -> TrainState:
    params = init(cfg, gen, device)
    dev = tree_leaves(params)[0].device
    return TrainState(torch.zeros((), dtype=torch.int32, device=dev), params,
                      opt.init(params))


def abstract_train_state(cfg: ModelConfig, opt: Optimizer) -> TrainState:
    return init_train_state(cfg, opt, _abstract_gen(), "meta")


def train_state_specs(cfg: ModelConfig, opt: Optimizer) -> TrainState:
    ps = param_specs(cfg)
    return TrainState(step=(), params=ps, opt_state=opt.state_specs(ps))


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: _device.DeviceLike | None = None) -> dict:
    family = _family(cfg)
    if family == "ssm":
        return X.init_xlstm_state(cfg, batch, device)
    return {"transformer": T.init_cache, "encdec": E.init_encdec_cache,
            "hybrid": HY.init_hymba_cache}[family](cfg, batch, max_len,
                                                   device)


def cache_specs(cfg: ModelConfig) -> dict:
    return {"transformer": T.cache_specs, "encdec": E.encdec_cache_specs,
            "ssm": X.xlstm_state_specs,
            "hybrid": HY.hymba_cache_specs}[_family(cfg)](cfg)


def make_prefill_step(cfg: ModelConfig, attn_impl: str = "kernel"
                      ) -> Callable:
    """``prefill(params, batch) -> (last-position logits, cache)``; the
    batch holds ``tokens``, and ``positions`` / ``vision_embeds`` (VLM) or
    ``frames`` (encdec) where the family takes them."""
    family = _family(cfg)

    def prefill(params, batch):
        tokens = batch["tokens"]
        if family == "transformer":
            return T.decoder_prefill(
                cfg, params, tokens, positions=batch.get("positions"),
                vision_embeds=batch.get("vision_embeds"), attn_impl=attn_impl)
        if family == "encdec":
            return E.encdec_prefill(cfg, params, tokens, batch["frames"],
                                    attn_impl=attn_impl)
        if family == "ssm":
            return X.xlstm_prefill(cfg, params, tokens, impl=attn_impl)
        return HY.hymba_prefill(cfg, params, tokens, attn_impl=attn_impl)
    return prefill


def make_decode_step(cfg: ModelConfig) -> Callable:
    """``decode(params, cache, tokens, positions=None) -> (logits,
    cache)``; ``positions`` reach the transformer families (M-RoPE's
    (3, B, 1)), as in the reference."""
    family = _family(cfg)
    if family == "transformer":
        def decode(params, cache, tokens, positions=None):
            return T.decoder_decode(cfg, params, cache, tokens,
                                    positions=positions)
        return decode
    fn = {"encdec": E.encdec_decode, "ssm": X.xlstm_decode,
          "hybrid": HY.hymba_decode}[family]

    def decode(params, cache, tokens, positions=None):
        return fn(cfg, params, cache, tokens)
    return decode


# --------------------------------------------------------------------------
# input specs (dry-run contract)
# --------------------------------------------------------------------------
def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """``meta`` stand-ins for every model input of this cell, with the
    reference's shapes and dtypes: tokens (and M-RoPE positions, and a
    cache's ``pos``) stay int32, as the reference's are (``batch_to``
    widens them when it places a batch)."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    dt = getattr(torch, cfg.dtype)

    def sds(dims, dtype):
        return torch.empty(dims, dtype=dtype, device="meta")

    if shape.mode in ("train", "prefill"):
        batch = {"tokens": sds((B, S), i32)}
        if shape.mode == "train":
            batch["labels"] = sds((B, S), i32)
        if cfg.family == "encdec":
            batch["frames"] = sds((B, cfg.encoder_seq, cfg.d_model), dt)
        if cfg.mrope:
            batch["positions"] = sds((3, B, S), i32)
            batch["vision_embeds"] = sds((B, cfg.vision_tokens, cfg.d_model),
                                         dt)
        return {"batch": batch}

    if shape.mode == "decode":
        cache = init_cache(cfg, B, shape.kv_len, "meta")
        cache["pos"] = sds((), i32)
        out = {"tokens": sds((B, 1), i32), "cache": cache}
        if cfg.mrope:
            out["positions"] = sds((3, B, 1), i32)
        return out

    raise ValueError(shape.mode)


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Logical-axis tree matching :func:`input_specs`."""
    tok = ("batch", "act_seq")
    if shape.mode in ("train", "prefill"):
        batch = {"tokens": tok}
        if shape.mode == "train":
            batch["labels"] = tok
        if cfg.family == "encdec":
            batch["frames"] = ("batch", None, None)
        if cfg.mrope:
            batch["positions"] = (None, "batch", "act_seq")
            batch["vision_embeds"] = ("batch", None, None)
        return {"batch": batch}
    out = {"tokens": ("batch", None), "cache": cache_specs(cfg)}
    if cfg.mrope:
        out["positions"] = (None, "batch", None)
    return out
