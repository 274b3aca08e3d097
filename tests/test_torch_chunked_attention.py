"""The reference's chunked prefill attention on the port
(``repro_torch.models.layers.chunked_attention`` and
``attention(impl="chunked")``) against ``repro.models.layers``, and each
family's ``make_prefill_step(cfg, attn_impl="chunked")`` against the
reference's, with the reference's parameters carried across by
``convert.tree_from_reference``.

Tolerances: f32 ``rtol = atol = 2e-5``, the band
``tests/test_torch_flash_attention.py`` holds attention to in f32 (the
two einsums reduce in other orders; measured: at most 4.8e-7); bf16
``3e-2``, that file's bf16 band (the probabilities are rounded to bf16
before the PV product on both sides, so an output may land a bf16 ulp
apart; measured: at most 2.0e-3); the smoke prefills as
``tests/torch_lm_parity.py`` states (logits 1e-4, every cache tensor
1e-4 of its largest magnitude; measured: logits at most 3.5e-6, caches
3.1e-6), at S = 1024, two chunks of the reference's 512.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import torch_lm_parity as H  # noqa: E402
from repro.models import layers as ref_L  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro_torch import device as port_device  # noqa: E402
from repro_torch.models import layers as port_L  # noqa: E402
from repro_torch.models import model as port_model  # noqa: E402

TOL = 2e-5
BF16_TOL = 3e-2
CHUNK = 64


@pytest.fixture(autouse=True)
def _cpu():
    with port_device.use_device("cpu"):
        yield


def _inputs(B, S, Hq, KV, hd, start, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, Hq, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    pos = (start + np.arange(S)).astype(np.int32)
    return q, k, v, pos


def _both(q, k, v, pos, *, causal, window, dtype):
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    want = ref_L.chunked_attention(
        *(jnp.asarray(a, jdt) for a in (q, k, v)), q_pos=jnp.asarray(pos),
        kv_pos=jnp.asarray(pos), causal=causal, window=window, chunk=CHUNK)
    got = port_L.chunked_attention(
        *(torch.from_numpy(a).to(dtype) for a in (q, k, v)),
        q_pos=torch.from_numpy(pos), kv_pos=torch.from_numpy(pos),
        causal=causal, window=window, chunk=CHUNK)
    assert got.dtype == dtype and tuple(got.shape) == q.shape
    return got.float().numpy(), np.asarray(want, np.float32)


# (causal, window, query heads, KV heads, chunks, first position): causal
# and bidirectional, unwindowed and a window shorter than a chunk, GQA and
# MHA, two and four chunks, positions from 0 and from elsewhere
CASES = [(True, 0, 4, 2, 2, 0), (True, 40, 4, 2, 4, 0),
         (False, 0, 4, 1, 2, 0), (False, 40, 6, 2, 4, 7),
         (True, 0, 4, 4, 4, 5), (True, 40, 8, 2, 2, 300)]


@pytest.mark.parametrize("causal,window,Hq,KV,chunks,start", CASES)
def test_chunked_attention_matches_reference_f32(causal, window, Hq, KV,
                                                 chunks, start):
    q, k, v, pos = _inputs(2, chunks * CHUNK, Hq, KV, 16, start)
    got, want = _both(q, k, v, pos, causal=causal, window=window,
                      dtype=torch.float32)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    # chunking is exact against the port's own unchunked attention: each
    # query row's softmax sees all keys either way
    full = port_L.gqa_attention(
        *(torch.from_numpy(a) for a in (q, k, v)),
        q_pos=torch.from_numpy(pos), kv_pos=torch.from_numpy(pos),
        causal=causal, window=window).numpy()
    np.testing.assert_array_equal(got, full)


@pytest.mark.parametrize("causal,window,Hq,KV,chunks,start", CASES)
def test_chunked_attention_matches_reference_bf16(causal, window, Hq, KV,
                                                  chunks, start):
    q, k, v, pos = _inputs(2, chunks * CHUNK, Hq, KV, 16, start, seed=1)
    got, want = _both(q, k, v, pos, causal=causal, window=window,
                      dtype=torch.bfloat16)
    np.testing.assert_allclose(got, want, rtol=BF16_TOL, atol=BF16_TOL)


def test_chunks_must_divide_the_queries():
    q, k, v, pos = _inputs(1, 3 * CHUNK // 2, 2, 1, 16, 0)
    with pytest.raises(ValueError, match="chunks"):
        port_L.chunked_attention(
            *(torch.from_numpy(a) for a in (q, k, v)),
            q_pos=torch.from_numpy(pos), kv_pos=torch.from_numpy(pos),
            chunk=CHUNK)


@pytest.mark.parametrize("S,kv_valid", [(CHUNK, False), (CHUNK // 2, False),
                                        (2 * CHUNK, True)])
def test_attention_chunks_only_long_prefills(monkeypatch, S, kv_valid):
    """``attention(impl="chunked")`` falls through to the einsum
    attention at S <= chunk and with ``kv_valid``, as the reference's
    does, and chunks otherwise."""
    q, k, v, pos = _inputs(2, S, 4, 2, 16, 0, seed=2)
    valid = np.ones((2, S), bool)
    valid[:, -3:] = False
    t = [torch.from_numpy(a) for a in (q, k, v)]
    p = torch.from_numpy(pos)
    kw = dict(q_pos=p, kv_pos=p, causal=True,
              kv_valid=torch.from_numpy(valid) if kv_valid else None)
    calls = []
    real = port_L.chunked_attention
    monkeypatch.setattr(port_L, "chunked_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got = port_L.attention(*t, impl="chunked", chunk=CHUNK, **kw)
    want = ref_L.attention(*(jnp.asarray(a) for a in (q, k, v)),
                           q_pos=jnp.asarray(pos), kv_pos=jnp.asarray(pos),
                           causal=True, impl="chunked", chunk=CHUNK,
                           kv_valid=jnp.asarray(valid) if kv_valid else None)
    assert calls == []
    np.testing.assert_array_equal(
        got.numpy(), port_L.gqa_attention(*t, **kw).numpy())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    if not kv_valid:
        long = _inputs(2, 2 * CHUNK, 4, 2, 16, 0, seed=3)
        port_L.attention(*(torch.from_numpy(a) for a in long[:3]),
                         q_pos=torch.from_numpy(long[3]),
                         kv_pos=torch.from_numpy(long[3]), impl="chunked",
                         chunk=CHUNK)
        assert calls == [1]


def test_unknown_impl_raises():
    q, k, v, pos = _inputs(1, 8, 2, 1, 16, 0)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    p = torch.from_numpy(pos)
    with pytest.raises(ValueError, match="impl"):
        port_L.attention(*t, q_pos=p, kv_pos=p, impl="chunk")
    assert port_L.prefill_route("chunked", p + 3) == "chunked"


# One arch of each transformer family (dense with a sliding window, MoE,
# VLM), the encoder-decoder and the hybrid.
FAMILIES = ["gemma3-12b", "olmoe-1b-7b", "qwen2-vl-72b", "whisper-tiny",
            "hymba-1.5b"]
S_PREFILL = 1024            # two of the reference's 512-query chunks


@pytest.mark.parametrize("arch,start", [(a, 0) for a in FAMILIES]
                         + [("qwen2-vl-72b", 5)])
def test_chunked_prefill_matches_reference(arch, start):
    """The family's smoke prefill with ``attn_impl="chunked"`` against the
    reference's: last-position logits and every cache tensor (the VLM
    also with M-RoPE positions from 5, which the route masks by without
    reading them)."""
    cfg_ref, cfg = H.configs(arch)
    params_ref, params = H.params_both(cfg_ref)
    tokens = np.random.default_rng(7).integers(0, cfg.vocab_size,
                                               (H.B, S_PREFILL))
    batch = H.batch_for(cfg, tokens=tokens, positions=H.vlm_positions(
        cfg, H.B, S_PREFILL, start) if cfg.mrope else None)
    lg_ref, cache_ref = jax.jit(ref_model.make_prefill_step(
        cfg_ref, attn_impl="chunked"))(params_ref, H._jnp(batch))
    with torch.no_grad():
        lg, cache = port_model.make_prefill_step(cfg, attn_impl="chunked")(
            params, H._torch(batch))
    assert lg.shape == (H.B, cfg.padded_vocab)
    H.assert_logits_close(lg.numpy(), np.asarray(lg_ref))
    H.assert_states_close(H._np_cache(cache), H._np_cache(cache_ref))


@pytest.mark.parametrize("arch", ["gemma3-12b", "hymba-1.5b"])
def test_chunked_loss_and_grads_match_reference(arch):
    """The training loss with ``attn_impl="chunked"`` (the reference's
    dry-run's ``--attn-impl chunked`` for a train cell) and its gradients,
    at two chunks a sequence (gemma3-12b cut to 6 layers: its 5:1
    local:global pattern once)."""
    cfg_ref, cfg = H.configs(arch, **({"num_layers": 6}
                                      if arch == "gemma3-12b" else {}))
    params_ref, params = H.params_both(cfg_ref)
    H.loss_and_grads(cfg_ref, cfg, params_ref, params,
                     H.train_batch(cfg, Bt=2, S=S_PREFILL),
                     attn_impl="chunked")
