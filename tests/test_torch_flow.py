"""The port's flow engine (``repro_torch.core.flow``) against the
reference's (the port's mirror of ``tests/test_flow_engine.py``).

* Smokes (tier-1): flow is a registered engine, every transport has a
  model, a transfer completes and is deterministic per seed, the packet
  engines never see the flow adapter, star / hier / gossip fleet rounds
  and async run, a fleet is deterministic per seed.
* Bit for bit against the reference's own flow engine: the keyed draws
  (``flow_uniform``, ``keyed_binomial`` across its edges and its underflow
  branch, ``stochastic_round``, ``pick_missing``, ``reorder_prob``), each
  loss model's ``stationary_loss_p`` and ``Link.expected_propagation_ns``;
  single-link transfers of every transport (``sim.stats``, the sender's
  ``TxnStats``, what was delivered), including a lossy jittered link that
  reaches ``spurious_reorder_nacks`` and the NACK-budget branch of
  ``flow_recover``; and consensus fleets of every transport under star,
  hier and gossip plus one async fleet (``sim.stats``, ``hop_bytes``,
  round records, losses and the global parameters' bytes).
* The flow-related properties of ``tests/test_rng_properties.py`` on the
  port's draws, over seeded key material (the lane-correlation case is
  left out: it fails in the reference).
* Distributional gates (``-m stats``): port flow against port batched
  through ``tests/statcheck.py`` unchanged, at the reference's
  tolerances.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import channel as ref_channel  # noqa: E402
from repro.core import flow as ref_flow  # noqa: E402
from repro_torch import device as port_device  # noqa: E402
from repro_torch.core import channel as port_channel  # noqa: E402
from repro_torch.core import flow as port_flow  # noqa: E402
from repro_torch.core.packets import Packet, PacketKind  # noqa: E402
from repro_torch.core.simulator import ENGINES, Simulator  # noqa: E402
from repro_torch.core.transport import (available_transports,  # noqa: E402
                                        make_transport)

sys.path.insert(0, os.path.dirname(__file__))
from statcheck import Tolerance, compare_sweeps, sweep  # noqa: E402
from torch_flow_metrics import (fleet, fleet_metrics,  # noqa: E402
                                fleet_view, transfer, transfer_metrics,
                                transfer_view)

SEEDS_LINK = range(100, 125)      # 25 seeds per single-link scenario
SEEDS_FLEET = range(300, 320)     # 20 seeds per fleet scenario
TRANSPORTS = ("mudp", "udp", "tcp", "mudp+fec")
U64 = (1 << 64) - 1


@pytest.fixture(autouse=True)
def _cpu():
    with port_device.use_device("cpu"):
        yield


# --------------------------------------------------------------------------
# Tier-1 smokes (the reference file's, on the port)
# --------------------------------------------------------------------------
def test_flow_is_a_registered_engine():
    assert ENGINES == ("per_packet", "batched", "flow")
    assert Simulator(engine="flow").engine == "flow"
    with pytest.raises(ValueError, match="unknown engine"):
        Simulator(engine="warp")


def test_every_transport_has_a_flow_model():
    assert port_flow.available_flow_models() == ["mudp", "mudp+fec", "tcp",
                                                  "udp"]
    assert set(port_flow.available_flow_models()) >= set(
        available_transports())


def test_a_transport_without_a_model_is_refused():
    class Pigeon:
        name, caps = "pigeon", None
    with pytest.raises(ValueError, match=r"'pigeon' has no registered flow "
                                         r"model.*'mudp', 'mudp\+fec', "
                                         r"'tcp', 'udp'"):
        port_flow.maybe_flow(Simulator(engine="flow"), Pigeon())
    with pytest.raises(ValueError, match="already registered"):
        port_flow.register_flow_model("mudp", lambda ctx: None)


def test_a_link_without_a_stationary_loss_is_refused():
    """A DropList link has no per-packet loss rate, so the flow engine
    refuses it at the transaction, as the reference does."""
    for ch in (ref_channel, port_channel):
        with pytest.raises(NotImplementedError, match="DropList"):
            ch.DropList([(1, 0)]).stationary_loss_p()


@pytest.mark.parametrize("kind", TRANSPORTS)
def test_flow_transfer_completes(kind):
    m = transfer_metrics("flow", kind, seed=42, loss_p=0.1, payload=24_000)
    assert m["completed"] == 1.0
    assert m["delivered"] == 1.0
    assert m["bytes_sent"] > 24_000
    assert m["sim_end_ns"] > 0


@pytest.mark.parametrize("kind", TRANSPORTS)
def test_flow_transfer_deterministic_per_seed(kind):
    a = transfer_metrics("flow", kind, seed=7, loss_p=0.1)
    b = transfer_metrics("flow", kind, seed=7, loss_p=0.1)
    c = transfer_metrics("flow", kind, seed=8, loss_p=0.1)
    assert a == b
    assert a != c


def test_flow_is_additive_to_packet_engines():
    base = make_transport("mudp")
    for engine in ("per_packet", "batched"):
        assert port_flow.maybe_flow(Simulator(engine=engine), base) is base
    wrapped = port_flow.maybe_flow(Simulator(engine="flow"), base)
    assert isinstance(wrapped, port_flow.FlowTransport)
    assert wrapped is not base
    assert (wrapped.name, wrapped.caps) == (base.name, base.caps)


@pytest.mark.parametrize("topology", ["star", "hier", "gossip"])
def test_flow_fleet_round_completes(topology):
    m = fleet_metrics("flow", "mudp", seed=5, n_clients=12, rounds=2,
                      topology=topology, n_params=128)
    assert m["round_time_ns"] > 0
    assert m["bytes_on_wire"] > 0
    assert m["final_loss"] >= 0.0


def test_flow_fleet_async_mode():
    m = fleet_metrics("flow", "mudp", seed=5, n_clients=12, rounds=2,
                      mode="async", n_params=128)
    assert m["round_time_ns"] > 0 and m["bytes_on_wire"] > 0


def test_flow_fleet_deterministic_per_seed():
    a = fleet_metrics("flow", "mudp", seed=9, n_clients=12, rounds=2,
                      n_params=128)
    b = fleet_metrics("flow", "mudp", seed=9, n_clients=12, rounds=2,
                      n_params=128)
    assert a == b


# --------------------------------------------------------------------------
# The keyed draws, bit for bit against the reference
# --------------------------------------------------------------------------
def _key_material(seed: int, n: int) -> list[tuple[int, ...]]:
    """n (stream seed, a, b, c, d) tuples of 64-bit key material, drawn
    from a seeded numpy generator, with the lanes' edge values mixed in."""
    rng = np.random.default_rng(seed)
    keys = [tuple(int(x) for x in rng.integers(0, U64, 5, dtype=np.uint64,
                                               endpoint=True))
            for _ in range(n)]
    return keys + [(0, 0, 0, 0, 0), (U64, U64, U64, U64, U64),
                   (1, 2, 3, 4, 5)]


@pytest.mark.parametrize("seed", range(4))
def test_flow_uniform_equals_the_reference(seed):
    for stream in (port_channel.FLOW_STREAM, port_channel.LOSS_STREAM,
                   port_channel.JITTER_STREAM):
        for s, a, b, c, d in _key_material(seed, 64):
            assert (port_channel.flow_uniform(stream, s, a, b, c, d)
                    == ref_channel.flow_uniform(stream, s, a, b, c, d))
    assert port_channel.FLOW_STREAM == ref_channel.FLOW_STREAM == 0xF7011


# (n, p) at the edges: n = 0, p = 0 and p = 1, tiny and one-packet bursts,
# the loss rates links model, and the underflow branch (q ** n == 0:
# n = 100,000 at p = 0.5, the probit approximation).
BINOMIAL_EDGES = [(0, 0.3), (-3, 0.3), (10, 0.0), (10, -0.1), (10, 1.0),
                  (10, 1.5), (1, 0.1), (1, 0.999), (40, 0.02), (64, 0.1),
                  (200, 0.35), (3000, 0.9), (100_000, 0.5),
                  (100_000, 0.02), (50_000, 0.99)]
UNIFORMS = [0.0, 1e-300, 1e-13, 1e-6, 0.01, 0.25, 0.4999999, 0.5, 0.5000001,
            0.75, 0.99, 1 - 1e-13, 1 - 2 ** -53]


@pytest.mark.parametrize("n,p", BINOMIAL_EDGES)
def test_keyed_binomial_equals_the_reference(n, p):
    got = [port_channel.keyed_binomial(n, p, u) for u in UNIFORMS]
    assert got == [ref_channel.keyed_binomial(n, p, u) for u in UNIFORMS]
    assert all(type(k) is int and 0 <= k <= max(n, 0) for k in got)
    if n <= 0 or p <= 0.0:
        assert got == [0] * len(UNIFORMS)
    elif p >= 1.0:
        assert got == [n] * len(UNIFORMS)


def test_keyed_binomial_underflow_branch():
    """n = 100,000 at p = 0.5 underflows the pmf walk's start (0.5 **
    100,000 == 0.0), so the draw is the clamped probit quantile: the
    reference's values, monotone in u, centred on n p."""
    n, p = 100_000, 0.5
    assert (1.0 - p) ** n == 0.0
    us = np.linspace(0.0, 1.0, 257)
    got = [port_channel.keyed_binomial(n, p, float(u)) for u in us]
    assert got == [ref_channel.keyed_binomial(n, p, float(u)) for u in us]
    assert got == sorted(got)
    assert abs(port_channel.keyed_binomial(n, p, 0.5) - n * p) <= 1


def test_stochastic_round_and_reorder_prob_equal_the_reference():
    xs = [0.0, 0.3, 1.0, 2.5, 7.999, 123.456]
    for x in xs:
        for u in UNIFORMS:
            assert (port_channel.stochastic_round(x, u)
                    == ref_channel.stochastic_round(x, u))
    for jit in (0, 1, 1000, 3_000_000):
        for gap in (0, 1, 500, 999, 1000, 2_999_999, 5_000_000):
            assert (port_flow.reorder_prob(jit, gap)
                    == ref_flow.reorder_prob(jit, gap))


def test_stationary_loss_and_expected_propagation_equal_the_reference():
    models = [("NoLoss", {}), ("BernoulliLoss", {"p": 0.07, "seed": 3}),
              ("BernoulliLoss", {"p": 1.7}), ("BernoulliLoss", {"p": -0.2}),
              ("GilbertElliott", {}),
              ("GilbertElliott", {"p_good_loss": 0.02, "p_bad_loss": 0.9,
                                  "p_bad": 0.2, "seed": 5})]
    for name, kw in models:
        got = getattr(port_channel, name)(**kw).stationary_loss_p()
        want = getattr(ref_channel, name)(**kw).stationary_loss_p()
        assert got == want and type(got) is type(want)
    for delay, jitter in ((0, 0), (5_000_000, 0), (5_000_000, 3),
                          (2_000_000_000, 1_500_001)):
        assert (port_channel.Link(1e7, delay, jitter_ns=jitter)
                .expected_propagation_ns()
                == ref_channel.Link(1e7, delay, jitter_ns=jitter)
                .expected_propagation_ns())


@pytest.mark.parametrize("k", [0, 1, 7, 49, 50, 80])
def test_pick_missing_equals_the_reference(k):
    """The keyed missing-sequence subset of one transaction (52 packets)."""
    picks = []
    for pkg in ("repro", "repro_torch"):
        run = transfer(pkg, "flow", "udp", 11, loss_p=0.0)
        flow_mod = ref_flow if pkg == "repro" else port_flow
        sender = run["sender"]
        ctx = flow_mod.FlowCtx(run["sim"], sender.src, sender.dst,
                               sender.packets, sender.cfg, sender.stats)
        picks.append(ctx.pick_missing(k))
    assert picks[0] == picks[1]
    assert len(picks[1]) == min(k, sender.total)


# --------------------------------------------------------------------------
# Transfers and fleets, bit for bit against the reference's flow engine
# --------------------------------------------------------------------------
LINK_CASES = {
    "bernoulli10": dict(loss_p=0.1),
    "bernoulli2": dict(loss_p=0.02, payload=24_000),
    "bursty": dict(loss_p=0.1, bursty=True),
    # Jitter of twenty serialization gaps reorders interiors behind the
    # last packet (spurious NACK volleys; under mudp+fec it also lands the
    # parity trailer first); 30% loss with one NACK-timer round spends the
    # volley budget (keepalive-driven volleys).
    "lossy_jittered": dict(loss_p=0.3, jitter_ns=20_000_000,
                           max_retries=1, payload=48_000),
    # mudp+fec repairs most volley losses from parity, so its budget needs
    # heavier loss and a longer transaction.
    "nack_budget": dict(loss_p=0.6, max_retries=2, payload=96_000),
    "short_timer": dict(loss_p=0.2, timeout_ns=50_000_000, max_retries=6),
}


@pytest.mark.parametrize("case", sorted(LINK_CASES))
@pytest.mark.parametrize("kind", TRANSPORTS)
def test_transfer_equals_the_reference(kind, case):
    for seed in (3, 4, 5):
        want = transfer_view(transfer("repro", "flow", kind, seed,
                                      **LINK_CASES[case]))
        got = transfer_view(transfer("repro_torch", "flow", kind, seed,
                                     **LINK_CASES[case]))
        assert got == want


def _recording_draws(monkeypatch, flow_mod):
    """Record each (phase, counter) a FlowCtx draws."""
    seen = []
    uniform = flow_mod.FlowCtx.uniform

    def spy(self, phase, counter=0, extra=0):
        seen.append((phase, counter))
        return uniform(self, phase, counter, extra)
    monkeypatch.setattr(flow_mod.FlowCtx, "uniform", spy)
    return seen


@pytest.mark.parametrize("kind", ["mudp", "mudp+fec"])
def test_lossy_jittered_link_reaches_every_recovery_branch(kind,
                                                           monkeypatch):
    """The lossy jittered cases draw the reorder conditionals of
    ``spurious_reorder_nacks`` (PH_REORD; under mudp+fec past the
    trailer-first gate's counter 0, at 64 + i) and the keepalive duplicates
    of ``flow_recover``'s NACK-budget branch (PH_LAST, counter >= 1000),
    and both packages draw the same keys and reach the same result."""
    draws = {}
    views = {}
    for pkg, flow_mod in (("repro", ref_flow), ("repro_torch", port_flow)):
        seen = _recording_draws(monkeypatch, flow_mod)
        views[pkg] = [transfer_view(transfer(pkg, "flow", kind, seed,
                                             **LINK_CASES[case]))
                      for case in ("lossy_jittered", "nack_budget")
                      for seed in range(3, 11)]
        draws[pkg] = seen
    assert draws["repro_torch"] == draws["repro"]
    assert views["repro_torch"] == views["repro"]
    phases = draws["repro_torch"]
    first = 65 if kind == "mudp+fec" else 1
    assert any(ph == port_flow.PH_REORD and c >= first for ph, c in phases)
    assert any(ph == port_flow.PH_LAST and c >= 1000 for ph, c in phases)


FLEET_CASES = {"star": dict(topology="star"),
               "hier": dict(topology="hier", cells=4),
               "gossip": dict(topology="gossip", neighbors=4)}


@pytest.mark.parametrize("topology", sorted(FLEET_CASES))
@pytest.mark.parametrize("transport", TRANSPORTS)
def test_fleet_equals_the_reference(transport, topology):
    kw = dict(n_clients=32, rounds=3, n_params=256, deadline_ns=8 * 10**9,
              **FLEET_CASES[topology])
    want = fleet_view(fleet("repro", "flow", transport, 21, **kw))
    got = fleet_view(fleet("repro_torch", "flow", transport, 21, **kw))
    assert got == want
    assert got["stats"]["packets_sent"] > 0 and len(got["rounds"]) == 3


@pytest.mark.parametrize("transport", ["mudp", "udp"])
def test_async_fleet_equals_the_reference(transport):
    kw = dict(n_clients=48, rounds=8, n_params=256, mode="async",
              deadline_ns=8 * 10**9)
    want = fleet_view(fleet("repro", "flow", transport, 22, **kw))
    got = fleet_view(fleet("repro_torch", "flow", transport, 22, **kw))
    assert got == want
    assert len(got["rounds"]) == 8


def test_adaptive_fleet_renegotiates_as_the_reference():
    """Under the flow engine each transaction takes the server's current
    ``transport_cfg_for(client)``, so the adaptive ladder's FEC geometry
    reaches the analytic model mid-run as in the reference."""
    import dataclasses

    from repro.core import fleet as ref_fleet
    from repro.core import rounds as ref_rounds
    from repro_torch.core import fleet as port_fleet
    from repro_torch.core import rounds as port_rounds

    def run(fl_mod, rounds_mod, backend):
        fl = fl_mod.FleetConfig(
            n_clients=24, seed=4, engine="flow", model="consensus",
            model_args={"n_params": 2048}, control="adaptive",
            cohort_mix=(("lte", 0.5), ("congested-edge", 0.5)),
            uplink="delta|ef|topk(0.15)|int8(1024)", downlink="int8(1024)")
        cfg = rounds_mod.FLConfig(
            aggregation="fedavg", aggregation_backend=backend,
            transport=rounds_mod.TransportConfig(kind="mudp+fec",
                                                 timeout_ns=2 * 10**9))
        build = fl_mod.build_fleet_training(fl, cfg)
        results = build.system.run_rounds(4)
        core = build.system.core
        return ([dataclasses.asdict(r) for r in results],
                dict(build.sim.stats), dict(core.renegotiations),
                {a: dataclasses.asdict(core.transport_cfg_for(a))
                 for a in sorted(core.renegotiations)})

    want = run(ref_fleet, ref_rounds, "numpy")
    got = run(port_fleet, port_rounds, "kernel")
    assert got == want
    assert sum(got[2].values()) > 0


# --------------------------------------------------------------------------
# The flow-related RNG properties (tests/test_rng_properties.py), on the
# port's draws over seeded key material
# --------------------------------------------------------------------------
STREAMS = (port_channel.LOSS_STREAM, port_channel.JITTER_STREAM,
           port_channel.FLOW_STREAM)


@pytest.mark.parametrize("seed", range(6))
def test_flow_uniform_is_the_vector_chain(seed):
    """scalar == vector: ``keyed_uniform`` on a packet, ``flow_uniform`` on
    its raw integers and ``keyed_uniforms`` over the burst agree bitwise."""
    rng = np.random.default_rng(1000 + seed)
    stream = STREAMS[seed % 3]
    s = int(rng.integers(0, U64, dtype=np.uint64, endpoint=True))
    n = 32
    txns = rng.integers(0, U64, n, dtype=np.uint64, endpoint=True)
    kinds = rng.choice([int(k) for k in PacketKind], n).astype(np.uint64)
    seqs = rng.integers(0, U64 - 1, n, dtype=np.uint64)
    attempts = rng.integers(0, U64, n, dtype=np.uint64, endpoint=True)
    vec = port_channel.keyed_uniforms(stream, s, txns, kinds, seqs, attempts)
    for i in range(n):
        t, k, q, a = (int(txns[i]), int(kinds[i]), int(seqs[i]),
                      int(attempts[i]))
        pkt = Packet(PacketKind(k), q, q + 1, "10.0.0.1", t, b"", 0,
                     attempt=a)
        assert port_channel.keyed_uniform(stream, s, pkt) == vec[i]
        assert port_channel.flow_uniform(stream, s, t, k, q, a) == vec[i]
        assert 0.0 <= vec[i] < 1.0


@pytest.mark.parametrize("seed", range(6))
def test_counter_stream_is_uniform(seed):
    rng = np.random.default_rng(2000 + seed)
    stream = STREAMS[seed % 3]
    s, txn = (int(x) for x in rng.integers(0, U64, 2, dtype=np.uint64,
                                           endpoint=True))
    n = 2048
    c = np.arange(n, dtype=np.uint64)
    z = np.zeros(n, np.uint64)
    u = port_channel.keyed_uniforms(stream, s, np.full(n, txn, np.uint64),
                                    z, c, z)
    assert abs(u.mean() - 0.5) < 0.05
    hist, _ = np.histogram(u, bins=8, range=(0.0, 1.0))
    assert hist.min() > 150          # expected 256 per octile
    assert len(np.unique(u)) == n


@pytest.mark.parametrize("seed", range(6))
def test_any_single_lane_change_changes_the_draw(seed):
    for s, txn, kind, seq, attempt in _key_material(3000 + seed, 16):
        kind, seq, attempt = (kind % 8, seq % (U64 - 1),
                              attempt % (U64 - 1))
        txn %= U64 - 1
        base = port_channel.flow_uniform(port_channel.FLOW_STREAM, s, txn,
                                         kind, seq, attempt)
        for variant in ((txn + 1, kind, seq, attempt),
                        (txn, kind + 1, seq, attempt),
                        (txn, kind, seq + 1, attempt),
                        (txn, kind, seq, attempt + 1)):
            assert port_channel.flow_uniform(port_channel.FLOW_STREAM, s,
                                             *variant) != base
        assert port_channel.flow_uniform(port_channel.LOSS_STREAM, s, txn,
                                         kind, seq, attempt) != base


# --------------------------------------------------------------------------
# Distributional gates (stats lane): port flow against port batched
# --------------------------------------------------------------------------
def _link_tols(loss_p: float) -> dict:
    rare = loss_p < 0.05
    return {
        "duration_ns": Tolerance(mean_rtol=0.15,
                                 var_hi=None if rare else 4.0,
                                 var_lo=None if rare else 16.0),
        "bytes_sent": Tolerance(mean_rtol=0.05,
                                var_hi=None if rare else 8.0,
                                var_lo=None),
        "retransmissions": Tolerance(mean_rtol=0.25, mean_atol=1.0,
                                     var_hi=None if rare else 8.0,
                                     var_lo=None),
        "completed": Tolerance(mean_rtol=0.0, mean_atol=0.05),
        "delivered": Tolerance(mean_rtol=0.0, mean_atol=0.05),
    }


@pytest.mark.stats
@pytest.mark.parametrize("kind", TRANSPORTS)
@pytest.mark.parametrize("loss_p,bursty", [(0.02, False), (0.1, False),
                                           (0.1, True)])
def test_link_distributional_equivalence(kind, loss_p, bursty):
    ref = sweep(lambda s: transfer_metrics("batched", kind, s,
                                           loss_p=loss_p, bursty=bursty),
                SEEDS_LINK)
    flow = sweep(lambda s: transfer_metrics("flow", kind, s,
                                            loss_p=loss_p, bursty=bursty),
                 SEEDS_LINK)
    fails = compare_sweeps(ref, flow, _link_tols(loss_p))
    assert not fails, "\n".join(fails)


FLEET_TOLS = {
    "round_time_ns": Tolerance(mean_rtol=0.20, var_lo=None),
    "bytes_on_wire": Tolerance(mean_rtol=0.05, var_hi=None, var_lo=None),
    "retransmissions": Tolerance(mean_rtol=0.30, mean_atol=2.0,
                                 var_hi=None, var_lo=None),
    "rounds_to_target": Tolerance(mean_rtol=0.25, mean_atol=1.0,
                                  var_hi=None, var_lo=None),
    "final_loss": Tolerance(mean_rtol=0.25, mean_atol=0.05,
                            var_hi=None, var_lo=None),
}


@pytest.mark.stats
@pytest.mark.parametrize("transport", TRANSPORTS)
@pytest.mark.parametrize("topology", ["star", "hier"])
def test_fleet_distributional_equivalence(transport, topology):
    ref = sweep(lambda s: fleet_metrics("batched", transport, s,
                                        topology=topology), SEEDS_FLEET)
    flow = sweep(lambda s: fleet_metrics("flow", transport, s,
                                         topology=topology), SEEDS_FLEET)
    fails = compare_sweeps(ref, flow, FLEET_TOLS)
    assert not fails, "\n".join(fails)


def _telemetry_metrics(engine: str, seed: int) -> dict:
    from repro_torch.core.fleet import (ConsensusObjective, FleetConfig,
                                        build_fleet)
    from repro_torch.core.rounds import FLConfig, TransportConfig
    NS = 1_000_000_000
    n_clients = 16
    fl = FleetConfig(n_clients=n_clients, seed=seed, engine=engine,
                     cohort_mix=(("lte", 1.0),),
                     round_deadline_ns=60 * NS)
    objective = ConsensusObjective(n_clients, 512, seed=seed)
    cfg = FLConfig(transport=TransportConfig(kind="mudp", timeout_ns=2 * NS,
                                             udp_deadline_ns=3 * NS))
    _, system, _ = build_fleet(fl, objective.init_params(),
                               objective.train_fn, cfg)
    system.run_rounds(3)
    health = system.core.telemetry.snapshot_all().values()
    n = max(1, len(health))
    return {
        "txns": sum(h.txns for h in health) / n,
        "rtt_ns": sum(h.rtt_ns for h in health) / n,
        "loss_rate": sum(h.loss_rate for h in health) / n,
        "goodput_bps": sum(h.goodput_bps for h in health) / n,
    }


TELEMETRY_TOLS = {
    "txns": Tolerance(mean_rtol=0.0),
    "rtt_ns": Tolerance(mean_rtol=0.20, var_hi=None, var_lo=None),
    "loss_rate": Tolerance(mean_rtol=0.5, mean_atol=0.01,
                           var_hi=None, var_lo=None),
    "goodput_bps": Tolerance(mean_rtol=0.25, var_hi=None, var_lo=None),
}


@pytest.mark.stats
def test_flow_telemetry_distributional_equivalence():
    ref = sweep(lambda s: _telemetry_metrics("batched", s), SEEDS_FLEET)
    flow = sweep(lambda s: _telemetry_metrics("flow", s), SEEDS_FLEET)
    fails = compare_sweeps(ref, flow, TELEMETRY_TOLS)
    assert not fails, "\n".join(fails)
