"""The MoE family on the port against the reference, at the smoke widths
(olmoe-1b-7b: 8 experts top-2, MHA; qwen3-moe-235b-a22b: 8 experts top-2,
GQA) in float32, with the reference's parameters: serving (prefill, its
KV cache, 4 greedy steps, the prefill-then-decode handoff), the loss and
its gradients through both expert paths (the scan over all experts, the
capacity-grouped ``ragged`` dispatch), and the ragged path's GShard drops
where the router sends more rows to an expert than its capacity.

Tolerances (``tests/torch_lm_parity.py``): logits and caches 1e-4, the
loss relative 1e-5, each gradient relative L2 1e-4 (measured: 4e-6,
1.4e-6 at most); a train step's grad norm relative 1e-4.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import torch_lm_parity as H  # noqa: E402
from repro import optim as ref_optim  # noqa: E402
from repro.configs.base import TrainConfig as RefTrainConfig  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.models import transformer as ref_T  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import device as port_device  # noqa: E402
from repro_torch import optim as port_optim  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.models import model as port_model  # noqa: E402
from repro_torch.models import transformer as port_T  # noqa: E402

ARCHS = ("olmoe-1b-7b", "qwen3-moe-235b-a22b")


@pytest.fixture(autouse=True)
def _cpu():
    with port_device.use_device("cpu"):
        yield


_RUNS: dict = {}


def _run(arch):
    if arch not in _RUNS:
        with port_device.use_device("cpu"):
            _RUNS[arch] = H.serve_both(arch)
    return _RUNS[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_matches_reference(arch):
    H.check_serving(_run(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_equals_full_prefill(arch):
    H.prefill_then_decode(_run(arch))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("moe_impl", ["scan", "ragged"])
def test_loss_and_grads_match_reference(arch, moe_impl):
    run = _run(arch)
    H.loss_and_grads(run["cfg_ref"], run["cfg"], run["params_ref"],
                     run["params"], H.train_batch(run["cfg"]),
                     moe_impl=moe_impl)


def _skewed(run, u):
    """The run's parameters with every token embedding shifted along the
    unit vector ``u`` and each layer's router column 0 along it, so most
    tokens pick expert 0, past its capacity."""
    params_ref = jax.tree_util.tree_map(np.copy, run["params_ref"])
    params_ref["embed"] += 2.0 * u
    params_ref["layers"]["router"][..., 0] = 10.0 * u
    return params_ref, convert.tree_from_reference(params_ref, H.CPU)


def test_ragged_drops_match_reference():
    """With a router skewed onto expert 0, the ragged block drops rows
    past the expert's capacity (cf 2: 2 * T*K / E rows); the rows kept are
    the first in the stable sort, as ``jnp.argsort``'s, so the port's
    block equals the reference's, and differs from the scan (which drops
    nothing)."""
    run = _run("olmoe-1b-7b")
    cfg_ref, cfg = run["cfg_ref"], run["cfg"]
    rng = np.random.default_rng(11)
    u = rng.standard_normal(cfg.d_model).astype(np.float32)
    u /= np.linalg.norm(u)
    params_ref, params = _skewed(run, u)
    x = (rng.standard_normal((4, 32, cfg.d_model)) + 3.0 * u).astype(
        np.float32)
    p_ref = {k: v[0] for k, v in params_ref["layers"].items()}
    p = {k: v[0] for k, v in params["layers"].items()}
    # The drops: tokens routed to expert 0 beyond its capacity.
    probs = jax.nn.softmax(jnp.einsum("bsd,de->bse", x, p_ref["router"]), -1)
    top_i = np.asarray(jax.lax.top_k(probs, cfg.num_experts_per_tok)[1])
    TK = top_i.size
    cap = int(-(-TK // cfg.num_experts) * port_T.MOE_CAPACITY_FACTOR)
    assert (top_i == 0).sum() > cap
    want = np.asarray(ref_T._moe_block_ragged(jnp.asarray(x), p_ref,
                                              cfg_ref))
    got = port_T._moe_block_ragged(torch.from_numpy(x), p, cfg).numpy()
    np.testing.assert_allclose(got, want, rtol=H.STATE_TOL,
                               atol=H.STATE_TOL)
    scan = port_T._moe_block(torch.from_numpy(x), p, cfg).numpy()
    assert np.abs(scan - got).max() > 100 * H.STATE_TOL
    batch = H.train_batch(cfg)
    H.loss_and_grads(cfg_ref, cfg, params_ref, params, batch,
                     moe_impl="ragged")
    losses = [float(port_model.loss_fn(cfg, moe_impl=impl)(
        params, port_model.batch_to(batch, H.CPU))) for impl in
        ("scan", "ragged")]
    assert abs(losses[0] - losses[1]) > 1e-3 * losses[0]   # rows dropped


def test_ragged_equals_scan_without_drops():
    """Below every expert's capacity the two expert paths compute the same
    function (the ragged one in float32 products)."""
    run = _run("qwen3-moe-235b-a22b")
    cfg = run["cfg"]
    p = {k: v[1] for k, v in run["params"]["layers"].items()}
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32))
    torch.testing.assert_close(port_T._moe_block_ragged(x, p, cfg),
                               port_T._moe_block(x, p, cfg), rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(ValueError, match="moe_impl"):
        port_T._ffn(x, p, cfg, "dense")


def test_ragged_train_step_with_accumulation_matches_reference():
    """``TrainConfig(moe_impl="ragged", grad_accum=2)`` reaches the loss
    on both sides: one SGD step's loss, grad norm and update."""
    run = _run("olmoe-1b-7b")
    kw = {"moe_impl": "ragged", "grad_accum": 2, "remat_policy": "none"}
    lr = 1e-3
    batch = H.train_batch(run["cfg"])
    ro = ref_optim.make_optimizer("sgd", ref_optim.constant(lr))
    po = port_optim.make_optimizer("sgd", port_optim.constant(lr))
    rs, rm = jax.jit(ref_model.make_train_step(
        run["cfg_ref"], ro, RefTrainConfig(**kw)))(
        ref_optim.TrainState(jnp.zeros((), jnp.int32), run["params_ref"],
                             ro.init(run["params_ref"])), batch)
    ps, pm = port_model.make_train_step(run["cfg"], po, TrainConfig(**kw))(
        port_optim.TrainState(torch.zeros((), dtype=torch.int32),
                              run["params"], po.init(run["params"])), batch)
    np.testing.assert_allclose(float(pm["loss"]), float(rm["loss"]),
                               rtol=H.LOSS_RTOL)
    np.testing.assert_allclose(float(pm["grad_norm"]), float(rm["grad_norm"]),
                               rtol=1e-4)
    got = ps.params["layers"]["we_up"] - run["params"]["layers"]["we_up"]
    want = (np.asarray(rs.params["layers"]["we_up"])
            - run["params_ref"]["layers"]["we_up"])
    assert H._rel(got.double().numpy(), want.astype(np.float64)) <= H.GRAD_TOL
