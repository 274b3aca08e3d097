"""The port's optimizers, schedules, token pipeline, link presets and
cross entropy against the reference's.

Tolerances: schedules, the token pipeline and the link presets are exact
(the same float32 operations, or the same numpy code); the optimizers on
the same params and grads for 5 steps agree within ``OPT_TOL`` (the two
frameworks round ``b ** t``, sqrt and the norm sums alike to within a
few float32 ulps of values of order 1); bfloat16 parameters within one
bfloat16 ulp of values of order 1; the cross entropy at relative 1e-6.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import optim as ref_optim  # noqa: E402
from repro.data import pipeline as ref_pipeline  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import device as port_device  # noqa: E402
from repro_torch import optim as port_optim  # noqa: E402
from repro_torch.data import pipeline as port_pipeline  # noqa: E402
from repro_torch.models import layers as port_layers  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

OPT_TOL = 1e-6
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _cpu():
    with port_device.use_device("cpu"):
        yield


def _np(tree):
    return [np.asarray(a, np.float64) if not isinstance(a, torch.Tensor)
            else a.detach().double().numpy() for a in tree]


# --------------------------------------------------------------------------
# Schedules: exact
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name,args,steps", [
    ("constant", (2e-3,), 5),
    ("linear_warmup", (3e-4, 100), 300),
    ("cosine_schedule", (3e-4, 100, 2_000), 2_020),
    ("cosine_schedule", (1.0, 10, 100), 120),
])
def test_schedules_match_exactly(name, args, steps):
    ref = getattr(ref_optim, name)(*args)
    port = getattr(port_optim, name)(*args)
    want = np.asarray([ref(jnp.asarray(s, jnp.int32)) for s in range(steps)],
                      np.float32)
    got = np.asarray([port(torch.tensor(s, dtype=torch.int32)).item()
                      for s in range(steps)], np.float32)
    assert got.tobytes() == want.tobytes()


# --------------------------------------------------------------------------
# Optimizers: same params and grads, several steps
# --------------------------------------------------------------------------
def _opt_case(seed):
    rng = np.random.default_rng(seed)
    params = {"w": rng.standard_normal((6, 5)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32),
              "s": {"k": rng.standard_normal((3, 4, 5)).astype(np.float32)}}
    grads = [{k: (rng.standard_normal(np.shape(v)) * 3).astype(np.float32)
              if k != "s" else
              {"k": (rng.standard_normal((3, 4, 5)) * 3).astype(np.float32)}
              for k, v in params.items()} for _ in range(5)]
    return params, grads


@pytest.mark.parametrize("name,kw", [
    ("adamw", {"weight_decay": 0.1, "grad_clip": 1.0}),
    ("adamw", {"weight_decay": 0.0, "grad_clip": 0.0}),
    ("adafactor", {"grad_clip": 0.5, "weight_decay": 0.01}),
    ("sgd", {"momentum": 0.9, "grad_clip": 1.0}),
    ("sgd", {}),
])
def test_optimizer_matches_reference(name, kw):
    params, grads = _opt_case(len(name) + len(kw))
    ro = ref_optim.make_optimizer(name, ref_optim.cosine_schedule(1e-2, 3, 20),
                                  **kw)
    po = port_optim.make_optimizer(
        name, port_optim.cosine_schedule(1e-2, 3, 20), **kw)
    rp = jax.tree_util.tree_map(jnp.asarray, params)
    pp = convert.tree_from_reference(params, CPU)
    rs, ps = ro.init(rp), po.init(pp)
    for step, g in enumerate(grads):
        rp, rs, rm = ro.update(jax.tree_util.tree_map(jnp.asarray, g), rs,
                               rp, jnp.asarray(step, jnp.int32))
        pp, ps, pm = po.update(convert.tree_from_reference(g, CPU), ps, pp,
                               torch.tensor(step, dtype=torch.int32))
        assert float(pm["lr"]) == float(rm["lr"])
        np.testing.assert_allclose(float(pm["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=1e-6)
    for a, b in zip(_np(jax.tree_util.tree_leaves(rp)),
                    _np(tree_leaves(pp))):
        np.testing.assert_allclose(b, a, rtol=0, atol=OPT_TOL)
    for a, b in zip(_np(jax.tree_util.tree_leaves(rs)),
                    _np(tree_leaves(ps))):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=OPT_TOL)


def test_adamw_bf16_params_keep_f32_moments_and_match_reference():
    params, grads = _opt_case(7)
    bf = {"w": jnp.asarray(params["w"], jnp.bfloat16)}
    ro = ref_optim.AdamW(schedule=ref_optim.constant(1e-2))
    po = port_optim.AdamW(schedule=port_optim.constant(1e-2))
    pp = convert.tree_from_reference(jax.tree_util.tree_map(np.asarray, bf),
                                     CPU)
    rs, ps = ro.init(bf), po.init(pp)
    assert ps["m"]["w"].dtype == torch.float32
    assert pp["w"].dtype == torch.bfloat16
    rp = bf
    for step, g in enumerate(grads[:3]):
        gw = {"w": g["w"]}
        rp, rs, _ = ro.update({"w": jnp.asarray(gw["w"], jnp.bfloat16)}, rs,
                              rp, jnp.asarray(step, jnp.int32))
        pp, ps, _ = po.update({"w": torch.from_numpy(gw["w"]).to(
            torch.bfloat16)}, ps, pp, step)
    assert pp["w"].dtype == torch.bfloat16
    # one bf16 ulp of values of order 1 at most
    np.testing.assert_allclose(pp["w"].float().numpy(),
                               np.asarray(rp["w"], np.float32), atol=2 ** -7)


def test_grad_clip_reports_the_norm_before_clipping():
    opt = port_optim.AdamW(schedule=port_optim.constant(1.0), grad_clip=1e-3,
                           weight_decay=0.0)
    params = {"w": torch.zeros(4)}
    _, _, m = opt.update({"w": torch.full((4,), 1e6)}, opt.init(params),
                         params, 0)
    assert float(m["grad_norm"]) > 1e3


@pytest.mark.parametrize("opt", [
    port_optim.AdamW(schedule=port_optim.constant(0.05), weight_decay=0.0),
    port_optim.Sgd(schedule=port_optim.constant(0.05), momentum=0.9),
])
def test_optimizer_converges_on_a_quadratic(opt):
    target = torch.tensor([1.5, -2.0, 0.5])
    params = {"w": torch.zeros(3)}
    state = opt.init(params)
    for step in range(200):
        params, state, _ = opt.update({"w": 2 * (params["w"] - target)},
                                      state, params, step)
    assert float(torch.sum((params["w"] - target) ** 2)) < 1e-3


# --------------------------------------------------------------------------
# Token pipeline: bit-identical
# --------------------------------------------------------------------------
def test_token_pipeline_is_bit_identical():
    for seed, (V, S, B) in enumerate(((100, 16, 4), (50304, 24, 2))):
        ref = ref_pipeline.TokenPipeline(V, S, B, seed=seed)
        port = port_pipeline.TokenPipeline(V, S, B, seed=seed)
        for step in (0, 1, 7):
            a, b = ref.batch(step), port.batch(step)
            for key in ("tokens", "labels"):
                assert a[key].dtype == b[key].dtype
                assert a[key].tobytes() == b[key].tobytes()
        np.testing.assert_array_equal(
            port.worker_slice(port.batch(3), 1, 2)["tokens"],
            ref.worker_slice(ref.batch(3), 1, 2)["tokens"])
    np.testing.assert_array_equal(
        port_pipeline.synthetic_batch(64, 8, 3, seed=5)["tokens"],
        ref_pipeline.synthetic_batch(64, 8, 3, seed=5)["tokens"])


@pytest.mark.parametrize("non_iid", [0.0, 0.3])
def test_federated_partitions_are_bit_identical(non_iid):
    ref = ref_pipeline.federated_partitions(128, 64, 8, 3, seed=0,
                                            non_iid=non_iid)
    port = port_pipeline.federated_partitions(128, 64, 8, 3, seed=0,
                                              non_iid=non_iid)
    for a, b in zip(ref, port):
        assert a._table_logits.tobytes() == b._table_logits.tobytes()
        assert a.batch(5)["tokens"].tobytes() == b.batch(5)["tokens"].tobytes()


def test_link_presets_are_the_references():
    from repro.core import channel as ref_channel
    from repro_torch import core as port_core
    for name in ("PAPER_LINK", "DCN_LINK", "WAN_LINK"):
        assert getattr(port_core, name) == getattr(ref_channel, name)


def test_cross_entropy_matches_reference_with_masked_labels():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32) * 3
    labels = rng.integers(-1, 11, (2, 5)).astype(np.int32)
    want = float(ref_layers.cross_entropy(jnp.asarray(logits),
                                          jnp.asarray(labels)))
    got = float(port_layers.cross_entropy(torch.from_numpy(logits),
                                          torch.from_numpy(labels)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
