"""Unified model API, the reference's ``repro.models.model`` in PyTorch:

  init(cfg, gen, device)        -> params tree (the reference's layout)
  loss_fn(cfg, ...)             -> callable(params, batch) -> scalar
  make_train_step(cfg, opt)     -> callable(state, batch) -> (state, metrics)
  init_train_state(cfg, opt, gen, device) -> TrainState
  init_cache(cfg, batch, max_len, device) -> per-family serve state
  make_prefill_step(cfg)        -> callable(params, batch) -> (logits, cache)
  make_decode_step(cfg)         -> callable(params, cache, tokens) -> (logits, cache)

Every family of the reference: ``dense``, ``moe`` and ``vlm``
(transformer), ``encdec`` (whisper), ``ssm`` (xLSTM) and ``hybrid``
(hymba).  Prefill runs the hand-written kernels (flash attention,
chunkwise mLSTM); ``attn_impl="plain"`` runs their plain versions
instead.  Prefill pads nothing: a cache comes back with the prompt's
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
from repro_torch.configs.base import ModelConfig, TrainConfig
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


# --------------------------------------------------------------------------
# loss / train step
# --------------------------------------------------------------------------
def loss_fn(cfg: ModelConfig, *, remat_policy: str = "dots",
            loss_chunk: int = 0, moe_impl: str = "scan"
            ) -> Callable[[Any, dict], torch.Tensor]:
    """The training loss: einsum attention, ``mlstm_chunked`` and the MoE
    by ``moe_impl`` (``"scan"`` or ``"ragged"``) under ``torch.autograd``,
    as the reference's default loss (no kernel has a backward, so none
    sits on it).  ``loss_chunk`` and ``moe_impl`` reach the transformer
    families, as in the reference."""
    family = _family(cfg)
    if family == "transformer":
        return functools.partial(T.decoder_loss, cfg,
                                 remat_policy=remat_policy,
                                 loss_chunk=loss_chunk, moe_impl=moe_impl)
    return functools.partial({"encdec": E.encdec_loss, "ssm": X.xlstm_loss,
                              "hybrid": HY.hymba_loss}[family], cfg,
                             remat_policy=remat_policy)


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
                 loss_chunk=tc.loss_chunk, moe_impl=tc.moe_impl)

    def _micro(key, val, n, i):
        """Microbatch ``i`` of ``n``: along the batch axis, which M-RoPE's
        (3, B, S) positions hold second."""
        axis = 1 if key == "positions" else 0
        if val.shape[axis] % n:
            raise ValueError(f"batch[{key!r}] holds {val.shape[axis]} "
                             f"rows, which {n} microbatches do not divide")
        return val.chunk(n, dim=axis)[i]

    def _grads(params, batch):
        if tc.grad_accum <= 1:
            return value_and_grad(lf, params, batch)
        n = tc.grad_accum
        adt = getattr(torch, tc.accum_dtype)
        gsum = [torch.zeros(p.shape, dtype=adt, device=p.device)
                for p in tree_leaves(params)]
        lsum = torch.zeros((), dtype=torch.float32)
        for i in range(n):
            micro = {key: _micro(key, val, n, i)
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
    family = _family(cfg)
    if family == "ssm":
        return X.init_xlstm_state(cfg, batch, device)
    return {"transformer": T.init_cache, "encdec": E.init_encdec_cache,
            "hybrid": HY.init_hymba_cache}[family](cfg, batch, max_len,
                                                   device)


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
