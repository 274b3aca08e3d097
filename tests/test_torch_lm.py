"""LM serving on the port against the reference, at the smoke widths.

``smoke_variant(gemma3-12b)`` (12 layers, d 64, 4 query heads over 2 KV
heads, window 16, five local layers to one global) and
``smoke_variant(xlstm-350m)`` (16 layers: 2 groups of 7 mLSTM + 1 sLSTM)
in f32, with the reference's own parameters (``repro.models.model.init``)
carried across by ``convert.tree_from_reference``.  A 48-token prompt
(longer than the smoke window) goes through ``make_prefill_step`` on both
sides; then 4 greedy decode steps continue from the prefill's cache or
state, both sides fed the reference's tokens.

Tolerances (f32; the two frameworks sum in other orders): logits within
``LOGIT_TOL`` of the reference, over logits of order 1; KV caches and
recurrent states within ``STATE_TOL`` times the larger of 1 and the
tensor's largest magnitude.  The xLSTM's are wider because its 48-step
sLSTM recurrences amplify rounding: against a float64 run of the port at
the same parameters, either side's f32 prefill logits lie within half
its ``LOGIT_TOL`` (``test_logit_tolerance_covers_float32_rounding``).
On the CPU the prefill's kernels run their plain versions; the kernels
themselves are held against those on the card (``chip_smoke.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import smoke_variant as ref_smoke  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import device as port_device  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, smoke_variant  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as port_model  # noqa: E402
from repro_torch.models import transformer as port_T  # noqa: E402

B, P, GEN = 2, 48, 4
LOGIT_TOL = {"gemma3-12b": 1e-4, "xlstm-350m": 2e-3}
STATE_TOL = {"gemma3-12b": 1e-4, "xlstm-350m": 2e-3}


@pytest.fixture(autouse=True)
def _cpu():
    with port_device.use_device("cpu"):
        yield


def _serve_reference(arch: str) -> dict:
    """Reference prefill + 4 greedy decode steps, and the port's, on the
    same parameters and prompt."""
    cfg_ref = ref_smoke(ref_get_config(arch))
    cfg = smoke_variant(get_config(arch))
    params_ref = ref_model.init(cfg_ref, jax.random.PRNGKey(0))
    params = convert.tree_from_reference(params_ref, "cpu")
    prompt = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (B, P)).astype(np.int32)

    lg_ref, cache_ref = jax.jit(ref_model.make_prefill_step(cfg_ref))(
        params_ref, {"tokens": jnp.asarray(prompt)})
    decode_ref = jax.jit(ref_model.make_decode_step(cfg_ref))
    prefill = port_model.make_prefill_step(cfg)
    decode = port_model.make_decode_step(cfg)
    with torch.no_grad():
        lg, cache = prefill(params, {"tokens": torch.from_numpy(prompt)})
    out = {"cfg": cfg, "params": params, "prompt": prompt,
           "prefill": (np.asarray(lg_ref), lg.numpy()),
           "cache": (jax.tree_util.tree_map(np.asarray, cache_ref),
                     {k: v.numpy() if torch.is_tensor(v) else v
                      for k, v in cache.items()})}
    if cfg.family == "dense":
        pad = ((0, 0), (0, 0), (0, GEN), (0, 0), (0, 0))
        cache_ref = dict(cache_ref, k=jnp.pad(cache_ref["k"], pad),
                         v=jnp.pad(cache_ref["v"], pad))
        cache = port_T.grow_cache(cache, P + GEN)
    steps, tok = [], np.argmax(np.asarray(lg_ref), axis=-1)[:, None]
    for _ in range(GEN):
        lg_ref, cache_ref = decode_ref(params_ref, cache_ref,
                                       jnp.asarray(tok, jnp.int32))
        with torch.no_grad():
            lg, cache = decode(params, cache, torch.from_numpy(tok).long())
        steps.append((np.asarray(lg_ref), lg.numpy()))
        tok = np.argmax(np.asarray(lg_ref), axis=-1)[:, None]
    out["decode"] = steps
    out["decode_cache"] = (cache_ref, cache)
    return out


@pytest.fixture(scope="module")
def gemma():
    with port_device.use_device("cpu"):
        return _serve_reference("gemma3-12b")


@pytest.fixture(scope="module")
def xlstm():
    with port_device.use_device("cpu"):
        return _serve_reference("xlstm-350m")


def _run(request, arch):
    return request.getfixturevalue({"gemma3-12b": "gemma",
                                    "xlstm-350m": "xlstm"}[arch])


ARCHS = ("gemma3-12b", "xlstm-350m")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_match_reference(request, arch):
    run = _run(request, arch)
    ref, got = run["prefill"]
    assert got.shape == ref.shape == (B, run["cfg"].padded_vocab)
    np.testing.assert_allclose(got, ref, rtol=LOGIT_TOL[arch],
                               atol=LOGIT_TOL[arch])
    assert (np.argmax(got, -1) == np.argmax(ref, -1)).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_cache_matches_reference(request, arch):
    ref, got = _run(request, arch)["cache"]
    tol = STATE_TOL[arch]
    assert set(got) == set(ref)
    assert got["pos"] == int(ref["pos"]) == P
    for key in sorted(set(ref) - {"pos"}):
        assert got[key].shape == ref[key].shape, key
        scale = max(1.0, float(np.abs(ref[key]).max()))
        err = float(np.abs(got[key] - ref[key]).max())
        assert err <= tol * scale, (key, err, scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_decode_matches_reference(request, arch):
    run = _run(request, arch)
    for step, (ref, got) in enumerate(run["decode"]):
        np.testing.assert_allclose(got, ref, rtol=LOGIT_TOL[arch],
                                   atol=LOGIT_TOL[arch],
                                   err_msg=f"decode step {step}")
        assert (np.argmax(got, -1) == np.argmax(ref, -1)).all(), step
    cache_ref, cache = run["decode_cache"]
    assert cache["pos"] == int(cache_ref["pos"]) == P + GEN


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_equals_full_prefill(request, arch):
    """The handoff on the port alone: prefill of the first P-1 tokens and
    one decode step give the full prefill's last-position logits."""
    run = _run(request, arch)
    cfg, params = run["cfg"], run["params"]
    prompt = torch.from_numpy(run["prompt"]).long()
    with torch.no_grad():
        _, cache = port_model.make_prefill_step(cfg)(
            params, {"tokens": prompt[:, :-1]})
        if cfg.family == "dense":
            cache = port_T.grow_cache(cache, P)
        lg, _ = port_model.make_decode_step(cfg)(params, cache,
                                                 prompt[:, -1:])
    np.testing.assert_allclose(lg.numpy(), run["prefill"][1],
                               rtol=LOGIT_TOL[arch], atol=LOGIT_TOL[arch])


@pytest.mark.parametrize("arch", ARCHS)
def test_logit_tolerance_covers_float32_rounding(request, arch):
    """What the tolerances rest on: a float64 run of the port at the same
    parameters and prompt, against which both sides' f32 prefill logits
    lie within half of ``LOGIT_TOL``."""
    run = _run(request, arch)
    cfg = dataclasses.replace(run["cfg"], dtype="float64")

    def to64(tree):
        return {k: to64(v) if isinstance(v, dict) else v.double()
                for k, v in tree.items()}
    with torch.no_grad():
        exact, _ = port_model.make_prefill_step(cfg)(
            to64(run["params"]), {"tokens": torch.from_numpy(run["prompt"])})
    exact = exact.numpy()
    for side in run["prefill"]:
        assert np.abs(side - exact).max() <= LOGIT_TOL[arch] / 2


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_port_init_has_the_reference_tree(arch):
    """The port's own random init has the reference's tree: same keys,
    shapes and dtypes (the numbers differ: another generator)."""
    cfg_ref = ref_smoke(ref_get_config(arch))
    ref = jax.eval_shape(lambda: ref_model.init(cfg_ref,
                                                jax.random.PRNGKey(0)))
    got = port_model.init(smoke_variant(get_config(arch)),
                          torch.Generator().manual_seed(0), "cpu")
    flat_ref = jax.tree_util.tree_flatten_with_path(ref)[0]
    flat = {jax.tree_util.keystr(path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(
                jax.tree_util.tree_map(lambda t: t, got))[0]}
    assert len(flat) == len(flat_ref)
    for path, leaf in flat_ref:
        t = flat[jax.tree_util.keystr(path)]
        assert tuple(t.shape) == leaf.shape, path
        assert str(t.dtype).removeprefix("torch.") == str(leaf.dtype), path


def test_bf16_tree_round_trip_is_bit_exact():
    """A bfloat16 reference tree (gemma3's smoke widths in its published
    dtype) crosses to the port and back bit for bit, nested layout and
    stacked layer axis kept."""
    cfg_ref = dataclasses.replace(ref_smoke(ref_get_config("gemma3-12b")),
                                  dtype="bfloat16")
    tree = ref_model.init(cfg_ref, jax.random.PRNGKey(1))
    port = convert.tree_from_reference(tree, "cpu")
    assert port["layers"]["wq"].dtype == torch.bfloat16
    assert tuple(port["layers"]["wq"].shape) == tree["layers"]["wq"].shape
    back = convert.tree_to_reference(port)
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(tree)[0],
            jax.tree_util.tree_flatten_with_path(back)[0]):
        a = np.asarray(a)
        assert a.dtype == np.asarray(b).dtype, path
        np.testing.assert_array_equal(a.view(np.uint16),
                                      np.asarray(b).view(np.uint16),
                                      err_msg=str(path))
    # One value, by hand: the bits are the reference's, not a rounding.
    w = np.asarray(tree["embed"])[0, :4].astype(np.float32)
    np.testing.assert_array_equal(port["embed"][0, :4].float().numpy(), w)


@pytest.mark.parametrize("arch", ARCHS + (
    "olmoe-1b-7b", "qwen3-moe-235b-a22b", "qwen2-vl-72b", "whisper-tiny",
    "hymba-1.5b"))
def test_serve_smoke_on_cpu(arch, capsys):
    """Every family serves through the entry point (whisper by its encdec
    branch: frames, a prefill, the cache grown); the families' values
    against the reference are in tests/test_torch_{moe,vlm,encdec,hymba}.py."""
    serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch",
                "2", "--prompt-len", "6", "--gen", "3"])
    out = capsys.readouterr().out
    assert "generated (2, 3) tokens" in out
    assert out.count("seq") == 2


def test_serve_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--arch", "xlstm-350m", "--smoke"])
