"""Unified model API, the reference's ``repro.models.model`` in PyTorch:

  init(cfg, gen, device)        -> params tree (the reference's layout)
  loss_fn(cfg, ...)             -> callable(params, batch) -> scalar
  make_train_step(cfg, opt)     -> callable(state, batch) -> (state, metrics)
  init_train_state(cfg, opt, gen, device) -> TrainState
  init_cache(cfg, batch, max_len, device) -> per-family serve state
  make_prefill_step(cfg)        -> callable(params, batch) -> (logits, cache)
  make_decode_step(cfg)         -> callable(params, cache, tokens) -> (logits, cache)

Ported families: ``dense`` (transformer) and ``ssm`` (xLSTM).  Prefill runs
the hand-written kernels (flash attention, chunkwise mLSTM); ``attn_impl=
"plain"`` runs their plain versions instead.  Prefill pads nothing: a
transformer cache comes back with the prompt's length, and the caller
grows it (``transformer.grow_cache``) before decoding past it.  The loss
runs what the reference's loss runs (einsum attention, ``mlstm_chunked``)
under ``torch.autograd``; no kernel sits on it.  The other families are
not ported yet (ROADMAP A3).
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.models import transformer as T
from repro_torch.models import xlstm as X
from repro_torch.optim import Optimizer, TrainState
from repro_torch.tree import rebuild, tree_leaves

PORTED_FAMILIES = ("dense", "ssm")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported to "
            f"repro_torch yet (ROADMAP A3: MoE, VLM, encdec and hybrid "
            f"serving and training come after the dense and ssm families)")


def init(cfg: ModelConfig, gen: torch.Generator,
         device: _device.DeviceLike | None = None) -> dict:
    _check_family(cfg)
    if cfg.family == "dense":
        return T.init_decoder(cfg, gen, device)
    return X.init_xlstm(cfg, gen, device)


# --------------------------------------------------------------------------
# loss / train step
# --------------------------------------------------------------------------
def loss_fn(cfg: ModelConfig, *, remat_policy: str = "dots",
            loss_chunk: int = 0) -> Callable[[Any, dict], torch.Tensor]:
    """The training loss: einsum attention and ``mlstm_chunked`` under
    ``torch.autograd``, as the reference's default loss (no kernel has a
    backward, so none sits on it)."""
    _check_family(cfg)
    if cfg.family == "dense":
        return functools.partial(T.decoder_loss, cfg,
                                 remat_policy=remat_policy,
                                 loss_chunk=loss_chunk)
    return functools.partial(X.xlstm_loss, cfg, remat_policy=remat_policy)


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
    shaped like ``params`` in the parameters' dtypes."""
    leaves = [leaf.detach().requires_grad_(True)
              for leaf in tree_leaves(params)]
    loss = lf(rebuild(params, iter(leaves)), batch)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), rebuild(params, iter(grads))


def make_train_step(cfg: ModelConfig, opt: Optimizer,
                    train_cfg: Optional[TrainConfig] = None):
    """``train_step(state, batch) -> (state, metrics)``: the loss and its
    gradient (accumulated over ``train_cfg.grad_accum`` microbatches in
    ``accum_dtype``, as the reference's scan does), then one optimizer
    update.  Metrics: ``loss``, ``grad_norm`` (before clipping), ``lr``,
    each a 0-d tensor.  The batch goes to the parameters' device."""
    tc = train_cfg or TrainConfig()
    lf = loss_fn(cfg, remat_policy=tc.remat_policy,
                 loss_chunk=tc.loss_chunk)

    def _grads(params, batch):
        if tc.grad_accum <= 1:
            return value_and_grad(lf, params, batch)
        n = tc.grad_accum
        for key, val in batch.items():
            if val.shape[0] % n:
                raise ValueError(f"batch[{key!r}] leads with "
                                 f"{val.shape[0]}, which {n} microbatches "
                                 f"do not divide")
        adt = getattr(torch, tc.accum_dtype)
        gsum = [torch.zeros(p.shape, dtype=adt, device=p.device)
                for p in tree_leaves(params)]
        lsum = torch.zeros((), dtype=torch.float32)
        for i in range(n):
            micro = {key: val.reshape(n, val.shape[0] // n,
                                      *val.shape[1:])[i]
                     for key, val in batch.items()}
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


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: _device.DeviceLike | None = None) -> dict:
    _check_family(cfg)
    if cfg.family == "dense":
        return T.init_cache(cfg, batch, max_len, device)
    return X.init_xlstm_state(cfg, batch, device)


def make_prefill_step(cfg: ModelConfig, attn_impl: str = "kernel"
                      ) -> Callable:
    _check_family(cfg)
    if cfg.family == "dense":
        def prefill(params, batch):
            return T.decoder_prefill(cfg, params, batch["tokens"],
                                     attn_impl=attn_impl)
        return prefill

    def prefill(params, batch):
        return X.xlstm_prefill(cfg, params, batch["tokens"], impl=attn_impl)
    return prefill


def make_decode_step(cfg: ModelConfig) -> Callable:
    _check_family(cfg)
    if cfg.family == "dense":
        def decode(params, cache, tokens):
            return T.decoder_decode(cfg, params, cache, tokens)
        return decode

    def decode(params, cache, tokens):
        return X.xlstm_decode(cfg, params, cache, tokens)
    return decode
