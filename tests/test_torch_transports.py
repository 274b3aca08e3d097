"""The port's udp, tcp and mudp+fec transports and its adaptive control
plane, against the reference.

* FEC geometry and parity packets, UDP's zero-filled reassembly and every
  transport's capability flags equal the reference's.
* The adaptive ladder (``AdaptivePolicy``): the mirror of the adaptive
  cases of ``tests/test_control.py`` run against the port — hysteresis,
  argument validation, server-side dedupe and counting of decisions,
  refusal of an aggregation-domain flip and of an uplink that does not
  describe itself, identical runs under both packet engines — plus the
  same decisions and renegotiation counts as the reference on the same
  fleet.
* ``fec_parity=0`` degrades ``mudp+fec`` to plain mudp, and FEC geometry
  is validated at configuration time.
* Engine equivalence (the mirror of ``tests/test_engine_equivalence.py``'s
  transfer and fleet-round cases): for every transport, one transfer over
  an adversarial link and a few fleet rounds hash the same under both
  packet engines, and the same as the reference.

Fleets here train the numpy consensus objective, so every number is
host-side and exact.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import control as ref_control  # noqa: E402
from repro.core import fec as ref_fec  # noqa: E402
from repro.core import fleet as ref_fleet  # noqa: E402
from repro.core import rounds as ref_rounds  # noqa: E402
from repro.core import transport as ref_transport  # noqa: E402
from repro.core import udp as ref_udp  # noqa: E402
from repro.core.channel import BernoulliLoss as RefBernoulli  # noqa: E402
from repro.core.channel import DropList as RefDropList  # noqa: E402
from repro.core.channel import GilbertElliott as RefGE  # noqa: E402
from repro.core.channel import Link as RefLink  # noqa: E402
from repro.core.channel import NoLoss as RefNoLoss  # noqa: E402
from repro.core.packetizer import packetize as ref_packetize  # noqa: E402
from repro.core.simulator import Simulator as RefSimulator  # noqa: E402
from repro.core.packets import make_data_packet as ref_data_packet  # noqa: E402
from repro_torch import device as port_device  # noqa: E402
from repro_torch.core import fec as port_fec  # noqa: E402
from repro_torch.core import transport as port_transport  # noqa: E402
from repro_torch.core import udp as port_udp  # noqa: E402
from repro_torch.core.channel import (BernoulliLoss, DropList,  # noqa: E402
                                      GilbertElliott, Link, NoLoss)
from repro_torch.core.control import (DECISION_FIELDS,  # noqa: E402
                                      DEFAULT_TIERS, AdaptivePolicy,
                                      ControlDecision, available_policies)
from repro_torch.core.fleet import (FleetConfig,  # noqa: E402
                                    build_fleet_training)
from repro_torch.core.packetizer import packetize  # noqa: E402
from repro_torch.core.packets import make_data_packet  # noqa: E402
from repro_torch.core.rounds import FLConfig, TransportConfig  # noqa: E402
from repro_torch.core.simulator import PACKET_ENGINES, Simulator  # noqa: E402
from repro_torch.core.telemetry import ClientHealth  # noqa: E402

NS = 1_000_000_000
UP_SPEC = "delta|ef|topk(0.15)|int8(1024)"


@pytest.fixture(autouse=True)
def _cpu():
    with port_device.use_device("cpu"):
        yield


def _build(engine: str, control: str = "static", *, n_clients: int = 10,
           seed: int = 3, rounds: int = 3, transport: str = "mudp+fec",
           ref: bool = False):
    """The fleet of ``tests/test_control.py``'s ``_build``, in the port or
    (``ref=True``) in the reference."""
    fl_cls, tc_cls, fc_cls, build = (
        (ref_rounds.FLConfig, ref_rounds.TransportConfig,
         ref_fleet.FleetConfig, ref_fleet.build_fleet_training) if ref
        else (FLConfig, TransportConfig, FleetConfig, build_fleet_training))
    fl = fl_cls(transport=tc_cls(
        kind=transport, uplink=UP_SPEC, downlink="int8(1024)",
        timeout_ns=2 * NS, udp_deadline_ns=3 * NS))
    fleet = fc_cls(n_clients=n_clients, seed=seed, engine=engine,
                   mode="sync", model="consensus",
                   model_args={"n_params": 256}, control=control)
    b = build(fleet, fl)
    b.system.run_rounds(rounds)
    return b


# --------------------------------------------------------------------------
# Transports against the reference
# --------------------------------------------------------------------------
def test_registry_and_caps_match_reference():
    assert port_transport.available_transports() == \
        ref_transport.available_transports()
    for kind in port_transport.available_transports():
        assert dataclasses.asdict(port_transport.make_transport(kind).caps) \
            == dataclasses.asdict(ref_transport.make_transport(kind).caps)


@pytest.mark.parametrize("total,block,k", [(1, 8, 1), (7, 8, 1), (20, 8, 2),
                                           (33, 4, 3), (16, 16, 0)])
def test_fec_geometry_matches_reference(total, block, k):
    if k == 0:
        assert port_fec.parity_groups(total, block, 0) == []
        return
    assert port_fec.parity_groups(total, block, k) == \
        ref_fec.parity_groups(total, block, k)
    assert port_fec.expected_parity_count(total, block, k) == \
        ref_fec.expected_parity_count(total, block, k)


def test_parity_packets_match_reference_bytes():
    rng = np.random.default_rng(0)
    payloads = [rng.integers(0, 256, 40 + 3 * s, dtype=np.uint8).tobytes()
                for s in range(1, 10)]
    ours = {s: make_data_packet(s, 9, "10.1.0.1", p, 5)
            for s, p in enumerate(payloads, 1)}
    theirs = {s: ref_data_packet(s, 9, "10.1.0.1", p, 5)
              for s, p in enumerate(payloads, 1)}
    groups = port_fec.parity_groups(9, 4, 2)
    for i, group in enumerate(groups, 1):
        a = port_fec.make_parity_packet(i, len(groups), group, ours,
                                        "10.1.0.1", 5, 9, 4, 2)
        b = ref_fec.make_parity_packet(i, len(groups), group, theirs,
                                       "10.1.0.1", 5, 9, 4, 2)
        assert (a.payload, a.checksum, a.seq, a.total) == \
            (b.payload, b.checksum, b.seq, b.total)
        assert port_fec.parse_parity_packet(a) == \
            ref_fec.parse_parity_packet(b)


def test_udp_partial_reassembly_matches_reference():
    payloads = {s: bytes([s]) * 10 for s in (1, 2, 4)}
    payloads[5] = b"\x05" * 3
    ours = {s: make_data_packet(s, 5, "a", p, 1)
            for s, p in payloads.items()}
    theirs = {s: ref_data_packet(s, 5, "a", p, 1)
              for s, p in payloads.items()}
    assert port_udp.reassemble_partial(ours, 5) == \
        ref_udp.reassemble_partial(theirs, 5)
    del ours[5], theirs[5]
    assert port_udp.reassemble_partial(ours, 5) == \
        ref_udp.reassemble_partial(theirs, 5)


# --------------------------------------------------------------------------
# The adaptive ladder (mirror of tests/test_control.py, section 3c)
# --------------------------------------------------------------------------
def _health(addr="c", loss=0.0, txns=5):
    return ClientHealth(addr=addr, txns=txns, loss_rate=loss)


def test_ladder_constants_match_reference():
    assert DECISION_FIELDS == ref_control.DECISION_FIELDS
    assert DEFAULT_TIERS == ref_control.DEFAULT_TIERS
    assert available_policies() == ref_control.available_policies()


def test_adaptive_policy_walks_the_ladder_with_hysteresis():
    pol = AdaptivePolicy(hi=0.03, lo=0.008, start_tier=1)
    ref = ref_control.AdaptivePolicy(hi=0.03, lo=0.008, start_tier=1)
    cfg = TransportConfig(kind="mudp+fec", uplink=UP_SPEC)
    assert pol.renegotiate("c", None, cfg) is None          # no telemetry yet
    walk = []
    for loss in (0.10, 0.02, 0.001, 0.0, 0.0):
        d = pol.renegotiate("c", _health(loss=loss), cfg)
        r = ref.renegotiate("c", _health(loss=loss), cfg)
        assert vars(d) == vars(r)
        walk.append(pol.tier_of("c"))
    assert walk == [2, 2, 1, 0, 0]          # escalate, hold, relax, floor
    d = pol.renegotiate("c", _health(loss=0.0), cfg)
    assert d.uplink == DEFAULT_TIERS[0]["uplink"]
    assert d.fec_parity == 0


def test_adaptive_policy_validates_args():
    with pytest.raises(ValueError, match="at least one tier"):
        AdaptivePolicy(tiers=())
    with pytest.raises(ValueError, match="unknown transport fields"):
        AdaptivePolicy(tiers=({"uplink": "raw", "mtu": 100},))
    with pytest.raises(ValueError, match="lo <= hi"):
        AdaptivePolicy(hi=0.01, lo=0.05)
    with pytest.raises(ValueError, match="start_tier"):
        AdaptivePolicy(start_tier=9)


def test_apply_decision_dedupes_and_counts():
    b = _build("batched", rounds=1)
    core = b.system.core
    addr = b.profiles[0].addr
    decision = ControlDecision(uplink=DEFAULT_TIERS[0]["uplink"],
                               fec_block=16, fec_parity=0)
    assert core._apply_decision(addr, decision) is True
    assert core.renegotiations[addr] == 1
    cfg = core.transport_cfg_for(addr)
    assert cfg.uplink == DEFAULT_TIERS[0]["uplink"]
    assert cfg.fec_parity == 0
    # Identical decision again: nothing changes, nothing is counted.
    assert core._apply_decision(addr, decision) is False
    assert core.renegotiations[addr] == 1
    # Other clients keep the base config.
    assert core.transport_cfg_for(b.profiles[1].addr).uplink == UP_SPEC


def test_renegotiated_uplink_cannot_flip_aggregation_domain():
    b = _build("batched", rounds=1)
    with pytest.raises(ValueError, match="domain"):
        b.system.core._apply_decision(
            b.profiles[0].addr,
            ControlDecision(uplink="topk(0.1)|int8(1024)"))


def test_adaptive_requires_self_describing_uplink():
    fl = FLConfig(transport=TransportConfig(kind="mudp", codec="int8"))
    fleet = FleetConfig(n_clients=2, seed=0, model="consensus",
                        model_args={"n_params": 64}, control="adaptive")
    with pytest.raises(ValueError, match="self-describing"):
        build_fleet_training(fleet, fl)


def test_adaptive_fleet_renegotiates_like_the_reference():
    ours = _build("batched", control="adaptive", n_clients=16, rounds=4)
    theirs = _build("batched", control="adaptive", n_clients=16, rounds=4,
                    ref=True)
    core = ours.system.core
    assert sum(core.renegotiations.values()) > 0
    assert core.renegotiations == theirs.system.core.renegotiations
    last = ours.system.history[-1]
    assert set(last.client_health) == {p.addr for p in ours.profiles}
    assert ours.model.loss(ours.system.global_params) < 0.5


def test_adaptive_identical_across_packet_engines():
    results = {}
    for engine in PACKET_ENGINES:
        b = _build(engine, control="adaptive", n_clients=8, rounds=3)
        results[engine] = (
            dict(b.system.core.renegotiations),
            b.system.core.telemetry.snapshot_all(),
            {k: v.tolist() for k, v in b.system.global_params.items()},
        )
    assert results["per_packet"] == results["batched"]


# --------------------------------------------------------------------------
# FEC parity 0 and config validation (mirror of section 3d)
# --------------------------------------------------------------------------
def test_transport_config_validates_fec_geometry():
    with pytest.raises(ValueError, match="fec_block"):
        TransportConfig(kind="mudp+fec", fec_block=0)
    with pytest.raises(ValueError, match="fec_parity"):
        TransportConfig(kind="mudp+fec", fec_parity=-1)
    TransportConfig(kind="mudp+fec", fec_parity=0)   # valid: no trailer


@pytest.mark.parametrize("engine", PACKET_ENGINES)
def test_fec_parity_zero_runs_every_packet_engine(engine):
    fl = FLConfig(transport=TransportConfig(
        kind="mudp+fec", fec_parity=0, timeout_ns=2 * NS,
        udp_deadline_ns=3 * NS))
    fleet = FleetConfig(n_clients=6, seed=1, engine=engine,
                        model="consensus", model_args={"n_params": 128})
    res = build_fleet_training(fleet, fl).system.run_rounds(2)
    assert len(res) == 2
    assert all(r.parity_packets == 0 for r in res)


def test_fec_parity_zero_matches_plain_mudp_on_packet_engines():
    """With no trailer, mudp+fec behaves exactly like mudp."""
    out = {}
    for kind, parity in (("mudp", 1), ("mudp+fec", 0)):
        fl = FLConfig(transport=TransportConfig(
            kind=kind, fec_parity=parity, timeout_ns=2 * NS,
            udp_deadline_ns=3 * NS))
        fleet = FleetConfig(n_clients=6, seed=2, engine="batched",
                            model="consensus", model_args={"n_params": 128})
        b = build_fleet_training(fleet, fl)
        b.system.run_rounds(2)
        out[kind] = ({k: v.tolist()
                      for k, v in b.system.global_params.items()},
                     b.sim.now_ns)
    assert out["mudp"] == out["mudp+fec"]


@pytest.mark.parametrize("kind", ["udp", "tcp", "mudp+fec"])
def test_baseline_fleets_match_reference(kind):
    """A lossy 12-client fleet per transport: the same round records and
    bitwise the same global model as the reference."""
    def run(ref):
        fl_cls, tc_cls, fc_cls, build = (
            (ref_rounds.FLConfig, ref_rounds.TransportConfig,
             ref_fleet.FleetConfig, ref_fleet.build_fleet_training) if ref
            else (FLConfig, TransportConfig, FleetConfig,
                  build_fleet_training))
        fl = fl_cls(aggregation="fedavg", transport=tc_cls(
            kind=kind, timeout_ns=2 * NS, udp_deadline_ns=3 * NS))
        fleet = fc_cls(n_clients=12, seed=5, round_deadline_ns=4 * NS,
                       model="consensus", model_args={"n_params": 500})
        b = build(fleet, fl)
        recs = [(r.arrived, r.failed, r.late_folded, r.retransmissions,
                 r.packets_sent, r.packets_dropped, r.bytes_sent)
                for r in b.system.run_rounds(3)]
        return recs, b.system.global_params["w"]
    (ra, wa), (rb, wb) = run(False), run(True)
    assert ra == rb
    np.testing.assert_array_equal(wa.view(np.uint32), wb.view(np.uint32))


# --------------------------------------------------------------------------
# Engine equivalence, against the reference too
# --------------------------------------------------------------------------
SERVER = "10.1.2.5"
_PORT = dict(sim=Simulator, link=Link, transport=port_transport,
             packetize=packetize, noloss=NoLoss, bernoulli=BernoulliLoss,
             ge=GilbertElliott, droplist=DropList)
_REF = dict(sim=RefSimulator, link=RefLink, transport=ref_transport,
            packetize=ref_packetize, noloss=RefNoLoss,
            bernoulli=RefBernoulli, ge=RefGE, droplist=RefDropList)
LOSSES = {
    "clean": (lambda m: m["noloss"](), 0, 2 * NS),
    "jitter": (lambda m: m["bernoulli"](p=0.05, seed=1), 8_000_000, 2 * NS),
    "bursty": (lambda m: m["ge"](p_good_loss=0.02, p_bad_loss=0.5,
                                 p_bad=0.15, seed=3), 0, 2 * NS),
    "droplist": (lambda m: m["droplist"]({(1, 0), (2, 0), (7, 0), (21, 1)}),
                 0, 2 * NS),
    "timer": (lambda m: m["bernoulli"](p=0.15, seed=4), 8_000_000,
              20_000_000),
}


def _transfer_digest(m, engine, kind, case, *, mtu=300, payload=6000):
    loss, jitter_ns, timeout_ns = LOSSES[case]
    sim = m["sim"](engine=engine)
    link = lambda seed: m["link"](1e7, 5_000_000, loss(m),  # noqa: E731
                                  jitter_ns=jitter_ns, jitter_seed=seed)
    sim.connect("10.1.0.9", SERVER, link(1), link(2))
    tr = m["transport"].make_transport(kind)
    cfg = m["transport"].TransportConfig(kind=kind, mtu=mtu,
                                         timeout_ns=timeout_ns,
                                         udp_deadline_ns=4 * NS)
    got = []
    tr.create_receiver(sim, sim.node(SERVER), cfg, got.append)
    data = bytes(range(256)) * (payload // 256)
    sender = tr.create_sender(sim, sim.node("10.1.0.9"), sim.node(SERVER),
                              m["packetize"](data, "10.1.0.9", txn=1,
                                             mtu=mtu), cfg)
    sender.start()
    sim.run()
    return repr((sim.now_ns, sorted(sim.stats.items()),
                 [(d.sender_addr, d.txn, d.total, d.complete,
                   d.reassemble()) for d in got],
                 dataclasses.astuple(sender.stats)))


@pytest.mark.parametrize("case", sorted(LOSSES))
@pytest.mark.parametrize("kind", ["mudp", "udp", "tcp", "mudp+fec"])
def test_transfer_identical_across_engines_and_reference(kind, case):
    ours = {e: _transfer_digest(_PORT, e, kind, case)
            for e in PACKET_ENGINES}
    assert ours["per_packet"] == ours["batched"]
    assert ours["batched"] == _transfer_digest(_REF, "batched", kind, case)


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("kind", ["mudp", "udp", "tcp", "mudp+fec"])
def test_fleet_rounds_identical_across_engines_and_reference(kind, seed):
    def run(ref, engine):
        fc_cls, fl_cls, tc_cls, build = (
            (ref_fleet.FleetConfig, ref_rounds.FLConfig,
             ref_rounds.TransportConfig, ref_fleet.build_fleet_training)
            if ref else (FleetConfig, FLConfig, TransportConfig,
                         build_fleet_training))
        fleet = fc_cls(n_clients=8, seed=seed, participation_fraction=0.75,
                       round_deadline_ns=90 * NS, engine=engine,
                       model="consensus", model_args={"n_params": 600})
        cfg = fl_cls(aggregation="fedavg",
                     transport=tc_cls(kind=kind, timeout_ns=4 * NS,
                                      udp_deadline_ns=6 * NS))
        b = build(fleet, cfg)
        results = [b.system.run_round() for _ in range(2)]
        return repr((b.sim.now_ns, sorted(b.sim.stats.items()),
                     [[getattr(r, f) for f in _ROUND_FIELDS]
                      for r in results],
                     b.system.global_params["w"].tobytes()))
    ours = {e: run(False, e) for e in PACKET_ENGINES}
    assert ours["per_packet"] == ours["batched"]
    assert ours["batched"] == run(True, "batched")


_ROUND_FIELDS = ("round_idx", "duration_ns", "arrived", "failed",
                 "skipped_unhealthy", "late_folded", "bytes_sent",
                 "packets_sent", "packets_dropped", "retransmissions",
                 "roster", "data_packets", "nack_packets", "parity_packets",
                 "decode_errors")
