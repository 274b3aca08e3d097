"""Batched client compute on the port, against its own per-client path and
the reference (the port's mirror of ``tests/test_client_compute.py``).

* The ``vmap`` and ``shard`` backends (one ``torch.func.vmap`` of the
  model's pure step over the stacked rows) give the *same rounds* as the
  per-client ``python`` backend — identical rosters, arrivals and
  simulated durations, parameters within the reference's
  ``assert_ulp_close`` bound (imported unchanged) and metrics within 64
  ULP — across seeds x transports x sync/async x topology.
  These run with one intra-op thread: MKL splits a single sgemm's
  reduction across its threads (so the per-client path itself rounds by
  thread count) while its batched sgemm does not; with one thread both
  run the same reduction order.
* The ``python`` backend is the per-client path: consensus fleets are
  bitwise the reference's; the MLP fleets under star (sync and async) and
  hier match the reference's round records, with parameters within
  ``atol=1e-4`` (the port's minibatch draws replaced by the reference's
  threefry draws, as in ``test_torch_fleet.py``).
* ``BatchTrainer`` mechanics, the registries, and the port's data layer.

``test_fleet_parity_mlp_over_mudp`` is left out: it fails in the
reference itself (ROADMAP §C).  The pinned orchestrator digests of the
default path are held by ``test_torch_rounds.py`` and ``chip_smoke.py``.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core.client_compute import make_model as ref_make_model  # noqa: E402,E501
from repro_torch import device as port_device  # noqa: E402
from repro_torch.core import FleetConfig, attach_trainer  # noqa: E402
from repro_torch.core.client_compute import (BatchTrainer,  # noqa: E402
                                             ConsensusModel, _aux_to_rows,
                                             available_models,
                                             available_train_backends,
                                             make_model, make_train_backend,
                                             register_model,
                                             register_train_backend)
from repro_torch.core.fleet import ConsensusObjective  # noqa: E402
from repro_torch.core.packetizer import flatten_to_vector  # noqa: E402
from repro_torch.data import mnist as port_mnist  # noqa: E402
from repro_torch.models import mlp as port_mlp  # noqa: E402
from test_client_compute import assert_ulp_close  # noqa: E402
from test_torch_mlp import jax_minibatch_indices  # noqa: E402
from torch_fleet_arms import (port_consensus_fleet,  # noqa: E402
                              port_training_fleet, records)

MLP_SMALL = {"n_train": 512, "n_test": 128, "shard_size": 32, "hidden": 16}


@pytest.fixture(autouse=True)
def _cpu():
    with port_device.use_device("cpu"):
        yield


@pytest.fixture
def one_thread():
    """One intra-op thread: the per-client sgemm and the batched one then
    reduce in the same order (see the module docstring)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _stack(model, k, seed=7):
    vec0 = flatten_to_vector(model.init_params())
    rng = np.random.default_rng(seed)
    return (vec0[None] + 0.01 * rng.standard_normal(
        (k, vec0.size))).astype(np.float32)


# --------------------------------------------------------------------------
# Registries
# --------------------------------------------------------------------------
class TestRegistries:
    def test_builtins_present(self):
        assert "consensus" in available_models()
        assert "mlp" in available_models()
        assert set(available_train_backends()) == {"python", "vmap",
                                                   "shard"}

    def test_unknown_names_raise(self):
        with pytest.raises(ValueError, match="unknown model"):
            make_model("resnet900", 4)
        with pytest.raises(ValueError, match="unknown train backend.*"
                                             "'python', 'shard', 'vmap'"):
            make_train_backend("cuda")

    def test_shadowing_refused(self):
        with pytest.raises(ValueError, match="already registered"):
            register_model("consensus", ConsensusModel)
        with pytest.raises(ValueError, match="already registered"):
            register_train_backend(
                "vmap", lambda: make_train_backend("vmap"))

    def test_fleet_config_validates(self):
        with pytest.raises(ValueError, match="unknown model"):
            FleetConfig(n_clients=4, model="resnet900")
        with pytest.raises(ValueError, match="unknown train backend"):
            FleetConfig(n_clients=4, train_backend="cuda")
        with pytest.raises(ValueError, match="model_args"):
            FleetConfig(n_clients=4, model_args={"hidden": 8})
        for backend in ("vmap", "shard"):
            assert FleetConfig(n_clients=4,
                               train_backend=backend).train_backend == backend


# --------------------------------------------------------------------------
# ConsensusModel == ConsensusObjective == the reference's, bit for bit
# --------------------------------------------------------------------------
class TestConsensusModel:
    def test_bit_identical_to_objective(self):
        model = make_model("consensus", 6, seed=3, n_params=128)
        obj = ConsensusObjective(6, 128, seed=3)
        np.testing.assert_array_equal(model.init_params()["w"],
                                      obj.init_params()["w"])
        params = {"w": np.linspace(-1, 1, 128, dtype=np.float32)}
        for i in (0, 5):
            got, gm = model.train_fn(i)(params, 0, None)
            want, wm = obj.train_fn(i)(params, 0, None)
            np.testing.assert_array_equal(got["w"], want["w"])
            assert gm == wm
        assert model.loss(params) == obj.loss(params)

    def test_bit_identical_to_reference_model(self):
        ours = make_model("consensus", 6, seed=3, n_params=128)
        theirs = ref_make_model("consensus", 6, seed=3, n_params=128)
        params = {"w": np.linspace(-1, 1, 128, dtype=np.float32)}
        for i in range(6):
            got, gm = ours.train_fn(i)(params, 2, None)
            want, wm = theirs.train_fn(i)(params, 2, None)
            np.testing.assert_array_equal(got["w"].view(np.uint32),
                                          want["w"].view(np.uint32))
            assert gm == wm


# --------------------------------------------------------------------------
# Compute-level backend parity
# --------------------------------------------------------------------------
@pytest.mark.parametrize("model_name", ["consensus", "mlp"])
def test_backend_parity_compute_level(model_name, one_thread):
    kwargs = ({"n_params": 96} if model_name == "consensus"
              else dict(MLP_SMALL))
    model = make_model(model_name, 8, seed=0, **kwargs)
    stack = _stack(model, 8)
    ci = np.arange(8, dtype=np.int32)
    ri = np.asarray([0, 0, 1, 1, 2, 2, 3, 3], np.int32)
    out_py, met_py = make_train_backend("python").train(model, stack, ci, ri)
    out_vm, met_vm = make_train_backend("vmap").train(model, stack, ci, ri)
    out_sh, met_sh = make_train_backend("shard").train(model, stack, ci, ri)
    assert_ulp_close(out_py, out_vm)
    # shard is vmap on one device: exactly equal.
    np.testing.assert_array_equal(out_sh, out_vm)
    assert len(met_py) == len(met_vm) == len(met_sh) == 8
    for a, b in zip(met_py, met_vm):
        assert set(a) == set(b)
        for key in a:
            assert_ulp_close(np.float32(a[key]), np.float32(b[key]),
                             bound=64)  # scalar summaries, looser


@pytest.mark.parametrize("n", [1, 5])
def test_vmap_k_rows_in_k_rows_out(n, one_thread):
    # Nothing is compiled, so no batch is padded: K rows in, K rows out.
    model = make_model("consensus", n, seed=1, n_params=64)
    stack = np.tile(flatten_to_vector(model.init_params()), (n, 1))
    ci = np.arange(n, dtype=np.int32)
    ri = np.zeros(n, np.int32)
    new, aux = model.train_batch(stack, ci, ri)
    assert tuple(new.shape) == (n, 64) and aux["local_gap"].shape == (n,)
    out, met = make_train_backend("vmap").train(model, stack, ci, ri)
    assert out.shape == (n, 64) and len(met) == n
    out_py, _ = make_train_backend("python").train(model, stack, ci, ri)
    assert_ulp_close(out_py, out)


@pytest.mark.parametrize("model_name", ["consensus", "mlp"])
def test_vmap_matches_the_reference_vmap(model_name, monkeypatch):
    """The port's batched step against the reference's ``jax.vmap`` one,
    on the reference's minibatch draws."""
    monkeypatch.setattr(port_mlp, "minibatch_indices", jax_minibatch_indices)
    kwargs = ({"n_params": 96} if model_name == "consensus"
              else dict(MLP_SMALL))
    ours = make_model(model_name, 8, seed=0, **kwargs)
    theirs = ref_make_model(model_name, 8, seed=0, **kwargs)
    stack = _stack(ours, 8)
    ci = np.arange(8, dtype=np.int32)
    ri = np.asarray([0, 1, 2, 3, 0, 1, 2, 3], np.int32)
    got, _ = make_train_backend("vmap").train(ours, stack, ci, ri)
    from repro.core.client_compute import make_train_backend as ref_backend
    want, _ = ref_backend("vmap").train(theirs, stack, ci, ri)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_vmap_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    model = make_model("consensus", 2, seed=0, n_params=8)
    stack = np.zeros((2, 8), np.float32)
    with port_device.use_device("cuda"):
        with pytest.raises(RuntimeError, match="cuda"):
            make_train_backend("vmap").train(
                model, stack, np.arange(2), np.zeros(2))
    with pytest.raises(RuntimeError, match="cuda"):
        make_model("mlp", 2, seed=0, device="cuda", **MLP_SMALL)


def test_aux_to_rows():
    rows = _aux_to_rows({"a": torch.tensor([1.0, 2.0]),
                         "b": torch.tensor([3.0, 4.0])}, 2)
    assert rows == [{"a": 1.0, "b": 3.0}, {"a": 2.0, "b": 4.0}]


# --------------------------------------------------------------------------
# Fleet-level parity: identical rounds across the scenario matrix
# --------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("transport", ["mudp", "udp"])
@pytest.mark.parametrize("mode", ["sync", "async"])
def test_fleet_parity_matrix(training_fleet, seed, transport, mode,
                             one_thread):
    bp, rp = port_training_fleet("python", seed=seed, transport=transport,
                                 mode=mode)
    bv, rv = port_training_fleet("vmap", seed=seed, transport=transport,
                                 mode=mode)
    # The event layer must be untouched by batching: same rosters, same
    # arrivals, same simulated durations, round for round.
    assert [r.roster for r in rp] == [r.roster for r in rv]
    assert [r.arrived for r in rp] == [r.arrived for r in rv]
    assert [r.duration_ns for r in rp] == [r.duration_ns for r in rv]
    assert_ulp_close(flatten_to_vector(bp.system.global_params),
                     flatten_to_vector(bv.system.global_params))
    # vmap actually batched: fewer backend calls than client-trainings.
    assert bv.trainer is not None
    assert len(bv.trainer.batch_sizes) < sum(bv.trainer.batch_sizes)
    # And the python path is the reference's, bit for bit.
    br, rr = training_fleet("python", seed=seed, transport=transport,
                            mode=mode)
    assert records(rp) == records(rr)
    np.testing.assert_array_equal(
        flatten_to_vector(bp.system.global_params).view(np.uint32),
        flatten_to_vector(br.system.global_params).view(np.uint32))


@pytest.mark.parametrize("topology,kw", [("hier", {"cells": 3}),
                                         ("gossip", {})])
def test_fleet_parity_topologies(training_fleet, topology, kw, one_thread):
    bp, rp = port_training_fleet("python", topology=topology, **kw)
    bv, rv = port_training_fleet("vmap", topology=topology, **kw)
    assert [r.arrived for r in rp] == [r.arrived for r in rv]
    assert_ulp_close(flatten_to_vector(bp.system.global_params),
                     flatten_to_vector(bv.system.global_params))
    br, rr = training_fleet("vmap", topology=topology, **kw)
    assert [r.arrived for r in rv] == [r.arrived for r in rr]
    assert_ulp_close(flatten_to_vector(bv.system.global_params),
                     flatten_to_vector(br.system.global_params))


@pytest.mark.parametrize("topology,mode", [("star", "sync"),
                                           ("star", "async"),
                                           ("hier", "sync")])
def test_mlp_fleets_match_reference(training_fleet, monkeypatch, topology,
                                    mode, one_thread):
    monkeypatch.setattr(port_mlp, "minibatch_indices", jax_minibatch_indices)
    kw = dict(model="mlp", rounds=2, n_clients=8, topology=topology,
              mode=mode, **({"cells": 2} if topology == "hier" else {}))
    bp, rp = port_training_fleet("python", **kw)
    bv, rv = port_training_fleet("vmap", **kw)
    br, rr = training_fleet("python", **kw)
    strip = [{k: v for k, v in r.items() if k != "client_health"}
             for r in records(rr)]
    assert [{k: v for k, v in r.items() if k != "client_health"}
            for r in records(rp)] == strip
    assert [r.arrived for r in rv] == [r.arrived for r in rp]
    assert_ulp_close(flatten_to_vector(bp.system.global_params),
                     flatten_to_vector(bv.system.global_params))
    for key, want in br.system.global_params.items():
        np.testing.assert_allclose(bp.system.global_params[key], want,
                                   rtol=0, atol=1e-4)
    # And the model learns on its synthetic shards.
    m = bv.model
    assert m.accuracy(bv.system.global_params) > m.accuracy(m.init_params())


def test_python_backend_attaches_no_trainer():
    build, _ = port_training_fleet("python")
    assert build.trainer is None
    assert build.system.core.batch_trainer is None


def test_attach_trainer_wires_every_training_site():
    model = make_model("consensus", 8, seed=0, n_params=16)
    for topology, kw, sites in (("star", {}, 1), ("hier", {"cells": 3}, 3),
                                ("gossip", {"neighbors": 2}, 1)):
        _, _, system, _ = port_consensus_fleet(topology, n=8, rounds=0,
                                               **kw)
        trainer = BatchTrainer(model, make_train_backend("vmap"), {})
        assert attach_trainer(system, trainer) == sites
    with pytest.raises(TypeError, match="attach a trainer"):
        attach_trainer(object(), trainer)


# --------------------------------------------------------------------------
# BatchTrainer mechanics
# --------------------------------------------------------------------------
class TestBatchTrainer:
    def _trainer(self, n=4):
        model = make_model("consensus", n, seed=0, n_params=32)
        index = {f"10.1.0.{i + 1}": i for i in range(n)}
        return model, BatchTrainer(model, make_train_backend("vmap"), index)

    def test_lazy_flush_batches_pending(self):
        model, tr = self._trainer()
        p = model.init_params()
        for i in range(3):
            tr.submit(("s", i), f"10.1.0.{i + 1}", p, 0)
        received, trained, metrics = tr.collect(("s", 1))
        assert tr.batch_sizes == [3]          # one call for all pending
        np.testing.assert_array_equal(received["w"], p["w"])
        want, _ = model.train_fn(1)(p, 0, None)
        assert_ulp_close(trained["w"], want["w"])
        # The other two were computed in the same flush.
        tr.collect(("s", 0))
        tr.collect(("s", 2))
        assert tr.batch_sizes == [3]

    def test_duplicate_and_unknown_keys(self):
        model, tr = self._trainer()
        p = model.init_params()
        tr.submit("a", "10.1.0.1", p, 0)
        tr.flush()
        with pytest.raises(RuntimeError, match="duplicate"):
            tr.submit("a", "10.1.0.1", p, 0)
        with pytest.raises(KeyError, match="never submitted"):
            tr.collect("ghost")
        with pytest.raises(KeyError, match="client index"):
            tr.submit("b", "172.16.0.9", p, 0)

    def test_flush_empty_is_noop(self):
        _, tr = self._trainer()
        tr.flush()
        assert tr.batch_sizes == []


# --------------------------------------------------------------------------
# The port's MNIST data layer offline, and dirichlet sharding
# --------------------------------------------------------------------------
class TestMnistOffline:
    def test_offline_is_deterministic(self):
        a = port_mnist.load_mnist(256, 64, seed=5)
        b = port_mnist.load_mnist(256, 64, seed=5)
        assert a.source == b.source == "synthetic"
        for f in ("x_train", "y_train", "x_test", "y_test"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert a.x_train.dtype == np.float32 and a.x_train.shape == (256, 784)
        assert a.n_train == 256

    def test_missing_idx_dir_is_synthetic(self, tmp_path):
        data = port_mnist.load_mnist(128, 32, seed=1, data_dir=str(tmp_path))
        assert data.source == "synthetic"
        ref = port_mnist.load_mnist(128, 32, seed=1)
        np.testing.assert_array_equal(data.x_train, ref.x_train)

    def test_seed_changes_data(self):
        a = port_mnist.load_mnist(128, 32, seed=0)
        b = port_mnist.load_mnist(128, 32, seed=1)
        assert not np.array_equal(a.x_train, b.x_train)

    def test_splits_are_distinct(self):
        d = port_mnist.load_mnist(128, 128, seed=0)
        assert not np.array_equal(d.x_train, d.x_test)


class TestDirichletShards:
    def test_deterministic_and_shaped(self):
        labels = np.repeat(np.arange(10), 50)
        a = port_mnist.dirichlet_shards(labels, 8, alpha=0.5, seed=3,
                                        shard_size=40)
        b = port_mnist.dirichlet_shards(labels, 8, alpha=0.5, seed=3,
                                        shard_size=40)
        np.testing.assert_array_equal(a, b)
        assert a.shape == (8, 40) and a.dtype == np.int32
        assert a.min() >= 0 and a.max() < len(labels)

    def test_low_alpha_concentrates_classes(self):
        labels = np.repeat(np.arange(10), 100)
        shards = port_mnist.dirichlet_shards(labels, 16, alpha=0.05, seed=0,
                                             shard_size=100)
        top2 = []
        for row in shards:
            hist = np.bincount(labels[row], minlength=10)
            top2.append(np.sort(hist)[-2:].sum() / hist.sum())
        assert np.mean(top2) > 0.8

    def test_validation(self):
        labels = np.arange(10)
        with pytest.raises(ValueError, match="n_clients"):
            port_mnist.dirichlet_shards(labels, 0)
        with pytest.raises(ValueError, match="alpha"):
            port_mnist.dirichlet_shards(labels, 2, alpha=0.0)
