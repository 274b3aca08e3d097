"""The port's data, MLP trainer and whole slice against the reference.

* ``SyntheticMnist``, ``load_mnist`` and ``dirichlet_shards`` are numpy in
  both packages and must agree bit for bit, as must the MLP's seeded
  ``init_params``.
* One client's local round: the port's trainer fed the reference's
  threefry minibatch indices (``minibatch_indices`` monkeypatched with the
  fold-in chain of ``repro.models.mlp.MnistMLPModel.jax_train``) lands
  within ``rtol=1e-5, atol=1e-6`` of ``jax_train``.
* The slice as a whole: 4 clients, two sync rounds of the MLP over mudp
  with lossy uplinks, ``int8(1024)`` uplinks and FedAvg.  The reference
  runs its Pallas kernels (interpret mode), the port its kernel backends
  on the CPU.  Transport counts match exactly every round (loss draws are
  keyed by packet identity, not content); the global models agree within
  one int8 code step per round (``2 * max_scale + 1e-5``), since the two
  trainers differ by float noise that the quantizer may round apart.
* No module of the port, and not ``chip_smoke.py``, imports JAX or the
  reference package.
"""

from __future__ import annotations

import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import repro.data.mnist as ref_mnist  # noqa: E402
from repro.core import channel as ref_channel  # noqa: E402
from repro.core import rounds as ref_rounds  # noqa: E402
from repro.core import simulator as ref_simulator  # noqa: E402
from repro.core import wire as ref_wire  # noqa: E402
from repro.models.mlp import MnistMLPModel as RefMLP  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import device as port_device  # noqa: E402
from repro_torch import fl_mnist  # noqa: E402
from repro_torch.data import mnist as port_mnist  # noqa: E402
from repro_torch.kernels import KernelError  # noqa: E402
from repro_torch.kernels.quantize import ops as quant_ops  # noqa: E402
from repro_torch.models import mlp as port_mlp  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
SMALL = dict(hidden=8, n_train=512, n_test=128, shard_size=64,
             local_steps=2)


@pytest.fixture(autouse=True)
def _cpu():
    with port_device.use_device("cpu"):
        yield


def jax_minibatch_indices(seed, client, round_idx, step, n, shard_len,
                          device):
    """The reference's draw (``mlp.py`` jax_train), as a torch tensor."""
    key = jax.random.fold_in(
        jax.random.fold_in(jax.random.PRNGKey(seed), client), round_idx)
    pick = jax.random.randint(jax.random.fold_in(key, step), (n,), 0,
                              shard_len)
    return torch.from_numpy(np.asarray(pick).astype(np.int64)).to(device)


# --------------------------------------------------------------------------
# Data
# --------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 5])
def test_synthetic_mnist_bitwise(seed):
    ours, theirs = port_mnist.SyntheticMnist(seed=seed), \
        ref_mnist.SyntheticMnist(seed=seed)
    np.testing.assert_array_equal(ours.templates, theirs.templates)
    for a, b in zip(ours.sample(64, client=3, step=2),
                    theirs.sample(64, client=3, step=2)):
        np.testing.assert_array_equal(a, b)


def test_load_mnist_bitwise():
    ours = port_mnist.load_mnist(256, 64, seed=5)
    theirs = ref_mnist.load_mnist(256, 64, seed=5, download=False)
    assert ours.source == theirs.source == "synthetic"
    for field in ("x_train", "y_train", "x_test", "y_test"):
        a, b = getattr(ours, field), getattr(theirs, field)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("alpha", [0.1, 0.5, 5.0])
def test_dirichlet_shards_bitwise(alpha):
    labels = ref_mnist.load_mnist(512, 8, seed=1, download=False).y_train
    np.testing.assert_array_equal(
        port_mnist.dirichlet_shards(labels, 6, alpha=alpha, seed=2,
                                    shard_size=40),
        ref_mnist.dirichlet_shards(labels, 6, alpha=alpha, seed=2,
                                   shard_size=40))


# --------------------------------------------------------------------------
# Model
# --------------------------------------------------------------------------
def test_init_params_and_convert_round_trip():
    ours = port_mlp.MnistMLPModel(2, seed=3, **SMALL)
    theirs = RefMLP(2, seed=3, download=False, **SMALL)
    a, b = ours.init_params(), theirs.init_params()
    assert sorted(a) == sorted(b)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key])
    params, layout = convert.from_reference(b, "cpu")
    assert [k for k, _ in layout] == ["b1", "b2", "w1", "w2"]
    back = convert.to_reference(params)
    for key in b:
        np.testing.assert_array_equal(back[key], b[key])
    flat = convert.flatten(params, layout).numpy()
    np.testing.assert_array_equal(
        flat, np.asarray(theirs._flatten_jax(
            {k: jnp.asarray(v) for k, v in b.items()})))
    assert ours.n_params == theirs.n_params


def test_one_local_round_matches_jax_train(monkeypatch):
    monkeypatch.setattr(port_mlp, "minibatch_indices",
                        jax_minibatch_indices)
    ours = port_mlp.MnistMLPModel(3, seed=0, **SMALL)
    theirs = RefMLP(3, seed=0, download=False, **SMALL)
    vec0 = np.concatenate([v.reshape(-1) for _, v in
                           sorted(theirs.init_params().items())])
    for client, round_idx in ((0, 0), (2, 5)):
        new, aux = ours.train_flat(torch.from_numpy(vec0), client,
                                   round_idx)
        want, want_aux = theirs.jax_train(jnp.asarray(vec0),
                                          jnp.int32(client),
                                          jnp.int32(round_idx))
        np.testing.assert_allclose(new.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(float(aux["train_loss"]),
                                   float(want_aux["train_loss"]),
                                   rtol=1e-5, atol=1e-6)


def test_minibatch_indices_keyed_not_sequential():
    a = port_mlp.minibatch_indices(0, 1, 2, 3, 32, 64, "cpu")
    b = port_mlp.minibatch_indices(0, 1, 2, 3, 32, 64, "cpu")
    c = port_mlp.minibatch_indices(0, 1, 2, 4, 32, 64, "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.dtype == torch.int64 and 0 <= int(a.min()) <= int(a.max()) < 64


# --------------------------------------------------------------------------
# The slice as a whole
# --------------------------------------------------------------------------
def _reference_system(n_clients: int):
    """The reference mirror of :func:`repro_torch.fl_mnist.build`."""
    model = RefMLP(n_clients, seed=fl_mnist.SEED, download=False, **SMALL)
    sim = ref_simulator.Simulator(engine=fl_mnist.ENGINE)
    clients = []
    for i in range(n_clients):
        addr = fl_mnist.client_addr(i)
        sim.connect(addr, fl_mnist.SERVER,
                    ref_channel.Link(1e8, 1_000_000, ref_channel.BernoulliLoss(
                        p=fl_mnist.LOSS_P, seed=1000 + i)),
                    ref_channel.Link(1e8, 1_000_000, ref_channel.NoLoss()))
        clients.append(ref_rounds.FLClient(addr, model.train_fn(i)))
    cfg = ref_rounds.FLConfig(
        aggregation="fedavg", aggregation_backend="kernel",
        transport=ref_rounds.TransportConfig(kind="mudp",
                                             uplink=fl_mnist.UPLINK))
    return ref_rounds.FederatedSystem(sim, fl_mnist.SERVER, clients,
                                      model.init_params(), cfg)


def test_slice_matches_reference_round_for_round(monkeypatch):
    monkeypatch.setattr(port_mlp, "minibatch_indices",
                        jax_minibatch_indices)
    ours, _ = fl_mnist.build(4, device="cpu", **SMALL)
    prev = ref_wire.set_batch_backend("pallas")
    try:
        theirs = _reference_system(4)
        dropped = 0
        for _ in range(2):
            a, b = ours.run_round(), theirs.run_round()
            for field in ("arrived", "failed", "packets_sent",
                          "packets_dropped", "retransmissions"):
                assert getattr(a, field) == getattr(b, field), field
            assert len(a.arrived) == 4
            dropped += a.packets_dropped
        assert dropped > 0      # the loss path was exercised
    finally:
        ref_wire.set_batch_backend(prev)
    max_scale = max(float(np.abs(np.concatenate(
        [v.reshape(-1) for v in c.params.values()])).max()) / 127.0
        for c in theirs.core.pool.clients.values())
    for key in theirs.global_params:
        np.testing.assert_allclose(ours.global_params[key],
                                   theirs.global_params[key], rtol=0,
                                   atol=2 * max_scale + 1e-5)


def test_kernel_failure_stops_the_round(monkeypatch):
    """A failing dequantize kernel raises out of the round; it is not
    degraded into zero-filled rows that FedAvg would fold."""
    def _launch_fails(*args, **kwargs):
        raise RuntimeError("dequantize_i8_f32 launch failed: cudaError_t 98")
    system, _ = fl_mnist.build(4, device="cpu", **SMALL)
    monkeypatch.setattr(quant_ops, "dequantize", _launch_fails)
    with pytest.raises(KernelError, match="cudaError_t 98"):
        system.run_round()
    assert system.core.decode_errors == 0


# --------------------------------------------------------------------------
# Import guard
# --------------------------------------------------------------------------
_FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|repro|benchmarks)(\.|\s|$)", re.MULTILINE)


def test_port_never_imports_jax_or_the_reference():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    offenders = [f"{f.relative_to(REPO)}: {m.group(0).strip()}"
                 for f in files for m in _FORBIDDEN.finditer(f.read_text())]
    assert not offenders, offenders
