"""Helpers for the LM families' parity tests (``tests/test_torch_moe.py``,
``test_torch_vlm.py``, ``test_torch_encdec.py``, ``test_torch_hymba.py``):
the port against ``repro.models.model`` at the smoke widths, in float32,
with the reference's own parameters carried across by
``convert.tree_from_reference`` and every input made with numpy.

:func:`serve_both` runs the reference's prefill and ``GEN`` greedy decode
steps and the port's on the same parameters and batch (both sides fed the
reference's tokens); :func:`prefill_then_decode` is the port's handoff
against its own full prefill; :func:`loss_and_grads` holds the loss and
its gradients.  The tolerances are ``tests/test_torch_lm.py``'s and
``tests/test_torch_train.py``'s for the transformer: logits and caches
within 1e-4 (times the larger of 1 and the tensor's largest magnitude for
a cache or state), the loss within relative 1e-5, each gradient within
relative L2 1e-4.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import smoke_variant as ref_smoke
from repro.data import pipeline as ref_pipeline
from repro.models import model as ref_model
from repro_torch import convert
from repro_torch.configs import get_config, smoke_variant
from repro_torch.models import model as port_model
from repro_torch.models import transformer as port_T
from repro_torch.tree import tree_leaves

B, P, GEN = 2, 48, 4
LOGIT_TOL = 1e-4
STATE_TOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
CPU = torch.device("cpu")


def configs(arch: str, **updates):
    """(reference config, port config) at the smoke widths, with
    ``updates`` on both."""
    return (dataclasses.replace(ref_smoke(ref_get_config(arch)), **updates),
            dataclasses.replace(smoke_variant(get_config(arch)), **updates))


def params_both(cfg_ref, seed: int = 0):
    """The reference's random parameters (numpy) and the port's copy."""
    ref = jax.tree_util.tree_map(
        np.asarray, jax.jit(ref_model.init, static_argnums=0)(
            cfg_ref, jax.random.PRNGKey(seed)))
    return ref, convert.tree_from_reference(ref, CPU)


def vlm_positions(cfg, batch: int, seq: int, start: int = 0) -> np.ndarray:
    """M-RoPE positions (3, B, S): the temporal channel ``start +
    arange(S)``; over the vision prefix the height and width channels
    walk a 2 x (V / 2) patch grid from ``start``; text tokens carry the
    temporal position in all three."""
    t = start + np.arange(seq, dtype=np.int32)
    pos = np.broadcast_to(t, (3, batch, seq)).copy()
    V = cfg.vision_tokens
    grid = np.arange(V)
    pos[1, :, :V] = start + grid // (V // 2)
    pos[2, :, :V] = start + grid % (V // 2)
    return pos


def batch_for(cfg, *, tokens: np.ndarray, vision: bool = True,
              positions: np.ndarray | None = None, seed: int = 5) -> dict:
    """A numpy prefill batch: ``tokens``, and the family's extra inputs
    (seeded frames for encdec; M-RoPE positions and a seeded vision
    prefix for the VLM)."""
    rng = np.random.default_rng(seed)
    Bt, S = tokens.shape
    out = {"tokens": tokens.astype(np.int32)}
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal(
            (Bt, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.mrope:
        out["positions"] = (vlm_positions(cfg, Bt, S) if positions is None
                            else positions)
        if vision:
            out["vision_embeds"] = rng.standard_normal(
                (Bt, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    return out


def _jnp(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
            batch.items()}


def _np_cache(cache: dict) -> dict:
    return {k: (v.numpy() if torch.is_tensor(v) else np.asarray(v))
            for k, v in cache.items()}


def _grow_ref(cache: dict, max_len: int) -> dict:
    pad = max_len - cache["k"].shape[2]
    widths = ((0, 0), (0, 0), (0, pad), (0, 0), (0, 0))
    return dict(cache, k=jnp.pad(cache["k"], widths),
                v=jnp.pad(cache["v"], widths))


def decode_positions(cfg, pos: int):
    """(reference, port) positions of one decode step at ``pos``: all
    three M-RoPE channels for the VLM, the default otherwise."""
    if not cfg.mrope:
        return None, None
    p = np.full((3, B, 1), pos, np.int32)
    return jnp.asarray(p), torch.from_numpy(p)


def serve_both(arch: str, **updates) -> dict:
    """Reference prefill + GEN greedy decode steps, and the port's, on the
    same parameters and batch (a P-token prompt)."""
    cfg_ref, cfg = configs(arch, **updates)
    params_ref, params = params_both(cfg_ref)
    prompt = np.random.default_rng(7).integers(0, cfg.vocab_size, (B, P))
    batch = batch_for(cfg, tokens=prompt)
    lg_ref, cache_ref = jax.jit(ref_model.make_prefill_step(cfg_ref))(
        params_ref, _jnp(batch))
    with torch.no_grad():
        lg, cache = port_model.make_prefill_step(cfg)(params, _torch(batch))
    out = {"cfg": cfg, "cfg_ref": cfg_ref, "params": params,
           "params_ref": params_ref, "batch": batch,
           "prefill": (np.asarray(lg_ref), lg.numpy()),
           "cache": (_np_cache(cache_ref), _np_cache(cache))}
    cache_ref = _grow_ref(cache_ref, P + GEN)
    cache = port_T.grow_cache(cache, P + GEN)
    decode_ref = jax.jit(ref_model.make_decode_step(cfg_ref))
    decode = port_model.make_decode_step(cfg)
    steps, tok = [], np.argmax(np.asarray(lg_ref), axis=-1)[:, None]
    for i in range(GEN):
        pos_ref, pos = decode_positions(cfg, P + i)
        lg_ref, cache_ref = decode_ref(params_ref, cache_ref,
                                       jnp.asarray(tok, jnp.int32), pos_ref)
        with torch.no_grad():
            lg, cache = decode(params, cache, torch.from_numpy(tok).long(),
                               pos)
        steps.append((np.asarray(lg_ref), lg.numpy()))
        tok = np.argmax(np.asarray(lg_ref), axis=-1)[:, None]
    out["decode"] = steps
    out["decode_cache"] = (_np_cache(cache_ref), _np_cache(cache))
    return out


def assert_logits_close(got, want, tol: float = LOGIT_TOL, msg: str = ""):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=msg)
    assert (np.argmax(got, -1) == np.argmax(want, -1)).all(), msg


def assert_states_close(got: dict, want: dict, tol: float = STATE_TOL):
    """Every tensor of a cache or state within ``tol`` times the larger of
    1 and its largest magnitude; the same keys and positions."""
    assert set(got) == set(want)
    assert int(got["pos"]) == int(want["pos"])
    for key in sorted(set(want) - {"pos"}):
        assert got[key].shape == want[key].shape, key
        assert got[key].dtype == want[key].dtype, key
        scale = max(1.0, float(np.abs(want[key]).max()))
        err = float(np.abs(got[key] - want[key]).max())
        assert err <= tol * scale, (key, err, scale)


def check_serving(run: dict) -> None:
    """Prefill logits and cache, then each greedy step's logits and the
    final cache, against the reference."""
    ref, got = run["prefill"]
    assert got.shape == ref.shape == (B, run["cfg"].padded_vocab)
    assert_logits_close(got, ref)
    assert_states_close(run["cache"][1], run["cache"][0])
    for step, (ref, got) in enumerate(run["decode"]):
        assert_logits_close(got, ref, msg=f"decode step {step}")
    assert_states_close(run["decode_cache"][1], run["decode_cache"][0])
    assert int(run["decode_cache"][1]["pos"]) == P + GEN


def prefill_then_decode(run: dict) -> None:
    """The handoff on the port alone: a prefill of the first P-1 tokens
    and one decode step give the full prefill's last-position logits."""
    cfg, params, batch = run["cfg"], run["params"], run["batch"]
    short = dict(batch, tokens=batch["tokens"][:, :-1])
    if "positions" in batch:
        short["positions"] = batch["positions"][..., :-1]
    _, pos = decode_positions(cfg, P - 1)
    if "positions" in batch:
        pos = torch.from_numpy(np.ascontiguousarray(
            batch["positions"][..., -1:]))
    with torch.no_grad():
        _, cache = port_model.make_prefill_step(cfg)(params, _torch(short))
        cache = port_T.grow_cache(cache, P)
        lg, _ = port_model.make_decode_step(cfg)(
            params, cache, torch.from_numpy(batch["tokens"][:, -1:]).long(),
            pos)
    assert_logits_close(lg.numpy(), run["prefill"][1])


def train_batch(cfg, Bt: int = 4, S: int = 32) -> dict:
    """The reference's data pipeline's batch, with the family's extra
    inputs (a vision prefix and M-RoPE positions, frames)."""
    b = ref_pipeline.TokenPipeline(cfg.vocab_size, S, Bt, seed=1).batch(0)
    out = batch_for(cfg, tokens=b["tokens"])
    out["labels"] = b["labels"]
    return out


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def loss_and_grads(cfg_ref, cfg, params_ref, params, batch, *,
                   grad_tol: float = GRAD_TOL, **kw) -> None:
    """The loss within relative LOSS_RTOL and each gradient within
    relative L2 ``grad_tol`` of the reference's, ``kw`` (``moe_impl``,
    ``remat_policy``, ...) on both sides."""
    kw.setdefault("remat_policy", "none")
    rl, rg = jax.value_and_grad(ref_model.loss_fn(cfg_ref, **kw))(
        params_ref, _jnp(batch))
    pl, pg = port_model.value_and_grad(
        port_model.loss_fn(cfg, **kw), params,
        port_model.batch_to(batch, CPU))
    np.testing.assert_allclose(float(pl), float(rl), rtol=LOSS_RTOL)
    ref_leaves = jax.tree_util.tree_leaves(rg)
    got_leaves = tree_leaves(pg)
    assert len(ref_leaves) == len(got_leaves)
    for a, b in zip(ref_leaves, got_leaves):
        assert tuple(b.shape) == a.shape
        assert _rel(b.double().numpy(), np.asarray(a, np.float64)) <= grad_tol
