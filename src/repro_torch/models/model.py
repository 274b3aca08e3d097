"""Unified model API for serving, the reference's ``repro.models.model``
(its serving half) in PyTorch:

  init(cfg, gen, device)        -> params tree (the reference's layout)
  init_cache(cfg, batch, max_len, device) -> per-family serve state
  make_prefill_step(cfg)        -> callable(params, batch) -> (logits, cache)
  make_decode_step(cfg)         -> callable(params, cache, tokens) -> (logits, cache)

Ported families: ``dense`` (transformer) and ``ssm`` (xLSTM).  Prefill runs
the hand-written kernels (flash attention, chunkwise mLSTM); ``attn_impl=
"plain"`` runs their plain versions instead.  Prefill pads nothing: a
transformer cache comes back with the prompt's length, and the caller
grows it (``transformer.grow_cache``) before decoding past it.  Training
(``loss_fn``, ``make_train_step``) and the other families are not ported
yet (ROADMAP A13).
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch import device as _device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.models import xlstm as X

PORTED_FAMILIES = ("dense", "ssm")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported to "
            f"repro_torch yet (ROADMAP A13: MoE, VLM, encdec and hybrid "
            f"serving come after the dense and ssm families)")


def init(cfg: ModelConfig, gen: torch.Generator,
         device: _device.DeviceLike | None = None) -> dict:
    _check_family(cfg)
    if cfg.family == "dense":
        return T.init_decoder(cfg, gen, device)
    return X.init_xlstm(cfg, gen, device)


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
