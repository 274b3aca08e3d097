"""The port's async (FedBuff-style) scheduler, against the reference (the
port's mirror of ``tests/test_async_orchestrator.py``).

Every case of the reference's file runs on the port: buffered
aggregation, staleness discounting with the underflow clamp and the
``max_staleness`` drops, per-client cadence, overlapping sessions on
every transport, the session watchdog, and deterministic replay.  The
staleness cases are hand-computed as in the reference.  Then the same
hand-built systems, and a seeded 24-client fleet, run through both
packages: round records (``dataclasses.asdict``) and global parameters
are bitwise equal, so the async flush's fold through the fedavg kernel
(staleness-discounted weights) is the reference's numpy fold.  The MLP's
async fleet is held against the reference in
``test_torch_client_compute.py``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.core as ref_core  # noqa: E402
import repro_torch.core as port_core  # noqa: E402
from repro.core import channel as ref_channel  # noqa: E402
from repro_torch import device as port_device  # noqa: E402
from repro_torch.core import (AsyncScheduler, ConsensusObjective,  # noqa: E402
                              FederatedSystem, FLClient, FLConfig,
                              FleetConfig, Simulator, TransportConfig,
                              available_transports, build_fleet,
                              make_transport)
from repro_torch.core import channel as port_channel  # noqa: E402
from repro_torch.kernels.fedavg import ops as fedavg_ops  # noqa: E402
from torch_fleet_arms import port_consensus_fleet, records  # noqa: E402

SERVER = "10.1.2.5"
NS = 1_000_000_000
MS = 1_000_000
PKGS = {"port": (port_core, port_channel), "ref": (ref_core, ref_channel)}


@pytest.fixture(autouse=True)
def _cpu():
    with port_device.use_device("cpu"):
        yield


def build(mode="async", n=4, cfg_kwargs=None, train_times=None,
          cadences=None, train_values=None, weights=None, loss_models=None,
          n_params=50, pkg="port"):
    """The reference file's hand-built star, in either package;
    ``loss_models`` maps an address to a callable ``channel -> model``."""
    core, channel = PKGS[pkg]
    sim = core.Simulator()
    clients = []
    for i in range(n):
        addr = f"10.1.2.{10 + i}"
        lm = (loss_models or {}).get(addr, lambda ch: ch.NoLoss())(channel)
        sim.connect(addr, SERVER, core.Link(1e8, 1 * MS, lm),
                    core.Link(1e8, 1 * MS, channel.NoLoss()))

        def fn(params, round_idx, client, v=(train_values or {}).get(
                f"10.1.2.{10 + i}", float(i + 1))):
            return ({k: np.full_like(p, v) for k, p in params.items()}, {})
        c = core.FLClient(addr, fn,
                          train_time_ns=(train_times or {}).get(
                              addr, (i + 1) * 100 * MS),
                          cadence_ns=(cadences or {}).get(addr, 50 * MS))
        if weights and addr in weights:
            c.weight = weights[addr]
        clients.append(c)
    cfg = core.FLConfig(mode=mode, aggregation="fedavg",
                        transport=core.TransportConfig(kind="mudp",
                                                       timeout_ns=NS),
                        **(cfg_kwargs or {}))
    params = {"w": np.zeros((n_params,), np.float32)}
    return sim, core.FederatedSystem(sim, SERVER, clients, params,
                                     cfg), clients


def _dead(n_seq, n_addr):
    dead = {(s, a) for s in range(1, n_seq) for a in range(0, n_addr)}
    return lambda ch: ch.DropList(dead)


class TestBufferedAggregation:
    def test_aggregates_at_buffer_k(self):
        _, system, _ = build(cfg_kwargs={"buffer_k": 2})
        results = system.run_rounds(3)
        assert len(results) == 3
        for r in results:
            assert len(r.arrived) == 2           # exactly K per flush
            assert r.metrics["buffer_size"] == 2

    def test_rounds_overlap_fast_client_reenters(self):
        _, system, _ = build(
            n=3, cfg_kwargs={"buffer_k": 2},
            train_times={"10.1.2.10": 50 * MS, "10.1.2.11": 60 * MS,
                         "10.1.2.12": 5 * NS})
        results = system.run_rounds(3)
        seen = [a for r in results for a in r.arrived]
        assert seen.count("10.1.2.10") >= 2      # re-entered mid-run
        assert all("10.1.2.12" in r.roster for r in results)

    def test_model_version_increments_per_aggregation(self):
        _, system, _ = build(cfg_kwargs={"buffer_k": 2})
        results = system.run_rounds(4)
        assert [r.metrics["model_version"] for r in results] == [1, 2, 3, 4]

    def test_partial_flush_on_drain(self):
        _, system, _ = build(n=2, cfg_kwargs={"buffer_k": 50})
        results = system.run_rounds(1)
        assert len(results) == 1
        assert len(results[0].arrived) >= 2

    def test_explicit_round_idx_rejected(self):
        _, system, _ = build()
        with pytest.raises(ValueError, match="sync-only"):
            system.run_round(round_idx=7)


class TestStaleness:
    def test_staleness_discount_hand_computed(self):
        _, system, _ = build(
            n=2, cfg_kwargs={"buffer_k": 1, "staleness_discount": 0.5},
            train_times={"10.1.2.10": 10 * MS, "10.1.2.11": 300 * MS},
            cadences={"10.1.2.10": 10 * NS, "10.1.2.11": 10 * NS},
            train_values={"10.1.2.10": 2.0, "10.1.2.11": 8.0})
        results = system.run_rounds(2)
        # Flush 1: client .10 alone (staleness 0) -> w = 2.0.  Flush 2:
        # client .11 alone, stale by 1; normalized over one contribution
        # -> w = 8.0.
        assert results[0].metrics["staleness_max"] == 0
        assert results[1].metrics["staleness_max"] == 1
        assert results[1].late_folded == 1
        np.testing.assert_allclose(system.global_params["w"], 8.0)

    def test_stale_update_downweighted_in_mixed_buffer(self):
        _, system, _ = build(
            n=3, cfg_kwargs={"buffer_k": 2, "staleness_discount": 0.5},
            train_times={"10.1.2.10": 10 * MS, "10.1.2.11": 20 * MS,
                         "10.1.2.12": 500 * MS},
            cadences={"10.1.2.10": 1000 * MS, "10.1.2.11": 1200 * MS},
            train_values={"10.1.2.10": 1.0, "10.1.2.11": 1.0,
                          "10.1.2.12": 10.0})
        results = system.run_rounds(2)
        # Flush 1: .10 + .11, fresh -> w = 1.0.  .12 arrives stale by 1
        # and pairs with .10's re-entry: w = (0.5*10 + 1*1) / 1.5 = 4.0
        assert results[1].metrics["staleness_max"] == 1
        np.testing.assert_allclose(system.global_params["w"], 4.0,
                                   atol=1e-6)

    def test_discount_underflow_clamped_not_dropped(self):
        _, system, _ = build(
            n=2, cfg_kwargs={"buffer_k": 1, "staleness_discount": 1e-200,
                             "staleness_floor": 1e-6},
            train_times={"10.1.2.10": 10 * MS, "10.1.2.11": 900 * MS},
            cadences={"10.1.2.10": 50 * MS},
            train_values={"10.1.2.10": 1.0, "10.1.2.11": 7.0})
        results = system.run_rounds(20)
        clamped = [r for r in results if r.staleness_clamped > 0]
        assert clamped, "straggler's discount**age must hit the floor"
        lone = [r for r in clamped if r.arrived == ["10.1.2.11"]]
        assert lone, "clamped update must still be aggregated"

    def test_max_staleness_drops_and_reports(self):
        _, system, _ = build(
            n=2, cfg_kwargs={"buffer_k": 1, "max_staleness": 0},
            train_times={"10.1.2.10": 10 * MS, "10.1.2.11": 900 * MS},
            cadences={"10.1.2.10": 50 * MS})
        results = system.run_rounds(20)
        assert sum(r.metrics["stale_dropped"] for r in results) >= 1


class TestCadence:
    def test_cadence_throttles_reentry(self):
        def run(cadence):
            _, system, _ = build(
                n=2, cfg_kwargs={"buffer_k": 1},
                train_times={"10.1.2.10": 10 * MS, "10.1.2.11": 10 * MS},
                cadences={"10.1.2.10": 1 * MS, "10.1.2.11": cadence})
            results = system.run_rounds(10)
            seen = [a for r in results for a in r.arrived]
            return seen.count("10.1.2.11")
        assert run(2 * NS) < run(1 * MS)


class TestTransportsAndDeterminism:
    @pytest.mark.parametrize("kind", available_transports())
    def test_async_runs_on_every_transport(self, kind):
        assert make_transport(kind).caps.concurrent_txns
        sim = Simulator()
        clients = []
        for i in range(4):
            addr = f"10.1.2.{10 + i}"
            sim.connect(addr, SERVER,
                        port_core.Link(1e8, 1 * MS, port_channel.NoLoss()),
                        port_core.Link(1e8, 1 * MS, port_channel.NoLoss()))

            def fn(params, round_idx, client, v=float(i + 1)):
                return ({k: np.full_like(p, v) for k, p in params.items()},
                        {})
            clients.append(FLClient(addr, fn, train_time_ns=(i + 1) * 50 * MS,
                                    cadence_ns=20 * MS))
        cfg = FLConfig(mode="async", buffer_k=2,
                       transport=TransportConfig(kind=kind, timeout_ns=NS,
                                                 udp_deadline_ns=NS))
        system = FederatedSystem(sim, SERVER, clients,
                                 {"w": np.zeros((50,), np.float32)}, cfg)
        results = system.run_rounds(3)
        assert len(results) == 3
        assert all(len(r.arrived) >= 1 for r in results)

    def test_async_replay_bit_identical(self):
        def one():
            fleet = FleetConfig(n_clients=12, seed=5, mode="async",
                                buffer_k=3, round_deadline_ns=10 * NS)
            obj = ConsensusObjective(12, 128, seed=5)
            cfg = FLConfig(transport=TransportConfig(kind="mudp",
                                                     timeout_ns=2 * NS))
            _, system, _ = build_fleet(fleet, obj.init_params(),
                                       obj.train_fn, cfg)
            results = system.run_rounds(4)
            return results, system.global_params["w"]
        ra, wa = one()
        rb, wb = one()
        assert records(ra) == records(rb)
        assert np.array_equal(wa, wb)

    def test_async_engines_bit_identical(self):
        def one(engine):
            fleet = FleetConfig(n_clients=12, seed=5, mode="async",
                                buffer_k=3, engine=engine,
                                round_deadline_ns=10 * NS)
            obj = ConsensusObjective(12, 128, seed=5)
            _, system, _ = build_fleet(fleet, obj.init_params(), obj.train_fn)
            results = system.run_rounds(4)
            return records(results), system.global_params["w"]
        ra, wa = one("per_packet")
        rb, wb = one("batched")
        assert ra == rb
        assert np.array_equal(wa, wb)


class TestFailureHandling:
    def test_dead_client_benched_and_others_progress(self):
        _, system, _ = build(
            n=3, cfg_kwargs={"buffer_k": 2, "unhealthy_after_failures": 1},
            loss_models={"10.1.2.12": _dead(4000, 80)},
            train_times={"10.1.2.10": 20 * MS, "10.1.2.11": 30 * MS,
                         "10.1.2.12": 20 * MS})
        results = system.run_rounds(80)
        assert len(results) == 80
        assert "10.1.2.12" in {a for r in results for a in r.failed}
        assert "10.1.2.12" not in {a for r in results for a in r.arrived}

    def test_session_watchdog_recovers_stuck_udp_leg(self):
        system = _udp_pair(dead_first=False)
        results = system.run_rounds(6)
        assert len(results) == 6
        assert sum(r.metrics["session_timeouts"] for r in results) >= 1

    def test_all_dead_fleet_terminates(self):
        system = _udp_pair(dead_first=True)
        results = system.run_rounds(4)      # must return, not hang
        assert len(results) <= 1            # at most the drain flush
        assert system.pool.benched(system.scheduler._agg_idx)


def _udp_pair(dead_first: bool, pkg: str = "port"):
    """Two clients over UDP with a dead uplink on the second (and on the
    first too when ``dead_first``): no transport failure ever fires, so
    only the session watchdog can move the run on."""
    core, channel = PKGS[pkg]
    dead = {(s, a) for s in range(1, 8000) for a in range(0, 200)}
    sim = core.Simulator()
    clients = []
    for i in range(2):
        addr = f"10.1.2.{10 + i}"
        lm = (channel.DropList(dead) if (i == 1 or dead_first)
              else channel.NoLoss())
        sim.connect(addr, SERVER, core.Link(1e8, 1 * MS, lm),
                    core.Link(1e8, 1 * MS, channel.NoLoss()))

        def fn(params, round_idx, client, v=float(i + 1)):
            return ({k: np.full_like(p, v) for k, p in params.items()}, {})
        clients.append(core.FLClient(
            addr, fn, train_time_ns=(10 if dead_first else 20) * MS,
            cadence_ns=(10 if dead_first else 300) * MS))
    extra = {"unhealthy_after_failures": 2} if dead_first else {}
    cfg = core.FLConfig(mode="async", buffer_k=2, round_deadline_ns=NS,
                        transport=core.TransportConfig(
                            kind="udp",
                            udp_deadline_ns=(30 if dead_first else 20) * NS),
                        **extra)
    return core.FederatedSystem(sim, SERVER, clients,
                                {"w": np.zeros((2000,), np.float32)}, cfg)


class TestSyncUnaffected:
    def test_sync_explicit_mode_matches_default(self):
        _, a, _ = build(mode="sync")
        _, b, _ = build(mode="sync")
        b.cfg = dataclasses.replace(b.cfg)      # mode survives replace()
        assert records(a.run_rounds(2)) == records(b.run_rounds(2))

    def test_sync_scheduler_ignores_cadence(self):
        _, sys_a, _ = build(mode="sync", cadences={"10.1.2.10": 10 * NS})
        _, sys_b, _ = build(mode="sync", cadences={"10.1.2.10": 0})
        assert records([sys_a.run_round()]) == records([sys_b.run_round()])

    def test_bad_mode_rejected(self):
        with pytest.raises(ValueError, match=r"mode.*'async', 'sync'"):
            FLConfig(mode="chaotic")
        with pytest.raises(ValueError, match="buffer_k"):
            FLConfig(mode="async", buffer_k=0)

    def test_async_requires_concurrent_txns(self):
        import repro_torch.core.server as server_mod

        class FakeTransport:
            name = "fake"
            caps = dataclasses.replace(
                make_transport("mudp").caps, concurrent_txns=False)

        core = object.__new__(server_mod.ServerCore)
        core.cfg = FLConfig(mode="async")
        core.transport = FakeTransport()
        with pytest.raises(ValueError, match="concurrent_txns"):
            AsyncScheduler(core)


# --------------------------------------------------------------------------
# Elastic membership under async
# --------------------------------------------------------------------------
def test_join_mid_run_enters_and_leave_forgets_wire_state():
    cfg = {"buffer_k": 2}
    sim, system, _ = build(n=2, cfg_kwargs=cfg)
    system.run_rounds(2)
    addr = "10.1.2.99"
    sim.connect(addr, SERVER,
                port_core.Link(1e8, 1 * MS, port_channel.NoLoss()),
                port_core.Link(1e8, 1 * MS, port_channel.NoLoss()))
    system.add_client(FLClient(
        addr, lambda p, r, c: ({k: np.full_like(v, 9.0)
                                for k, v in p.items()}, {}),
        train_time_ns=5 * MS, cadence_ns=5 * MS))
    results = system.run_rounds(4)
    assert addr in {a for r in results for a in r.arrived}
    core = system.core
    assert core.telemetry.snapshot(addr) is not None
    system.remove_client(addr)
    assert addr not in core.pool.clients
    assert addr not in core.pool.failures
    assert core.telemetry.snapshot(addr) is None
    results = system.run_rounds(2)
    assert addr not in {a for r in results for a in r.arrived}


# --------------------------------------------------------------------------
# The same systems through both packages
# --------------------------------------------------------------------------
SCENARIOS = {
    "buffer_k": dict(kw=dict(cfg_kwargs={"buffer_k": 2}), n=3),
    "staleness": dict(kw=dict(
        n=3, cfg_kwargs={"buffer_k": 2, "staleness_discount": 0.5},
        train_times={"10.1.2.10": 10 * MS, "10.1.2.11": 20 * MS,
                     "10.1.2.12": 500 * MS},
        cadences={"10.1.2.10": 1000 * MS, "10.1.2.11": 1200 * MS},
        train_values={"10.1.2.10": 1.0, "10.1.2.11": 1.0,
                      "10.1.2.12": 10.0}), n=2),
    "underflow_clamp": dict(kw=dict(
        n=2, cfg_kwargs={"buffer_k": 1, "staleness_discount": 1e-200,
                         "staleness_floor": 1e-6},
        train_times={"10.1.2.10": 10 * MS, "10.1.2.11": 900 * MS},
        cadences={"10.1.2.10": 50 * MS},
        train_values={"10.1.2.10": 1.0, "10.1.2.11": 7.0}), n=20),
    "max_staleness": dict(kw=dict(
        n=2, cfg_kwargs={"buffer_k": 1, "max_staleness": 0},
        train_times={"10.1.2.10": 10 * MS, "10.1.2.11": 900 * MS},
        cadences={"10.1.2.10": 50 * MS}), n=20),
    "weights_and_discount": dict(kw=dict(
        n=4, cfg_kwargs={"buffer_k": 3, "staleness_discount": 0.3},
        weights={"10.1.2.10": 0.7, "10.1.2.12": 2.5},
        train_values={"10.1.2.10": 0.1, "10.1.2.11": 1.7,
                      "10.1.2.12": -3.3, "10.1.2.13": 0.45}), n=6),
    "dead_client": dict(kw=dict(
        n=3, cfg_kwargs={"buffer_k": 2, "unhealthy_after_failures": 1},
        loss_models={"10.1.2.12": _dead(4000, 80)},
        train_times={"10.1.2.10": 20 * MS, "10.1.2.11": 30 * MS,
                     "10.1.2.12": 20 * MS}), n=40),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_hand_built_systems_match_reference(name):
    spec = SCENARIOS[name]
    out = {}
    for pkg in ("port", "ref"):
        _, system, _ = build(pkg=pkg, **spec["kw"])
        results = system.run_rounds(spec["n"])
        out[pkg] = (records(results), system.global_params["w"])
    assert out["port"][0] == out["ref"][0]
    np.testing.assert_array_equal(out["port"][1].view(np.uint32),
                                  out["ref"][1].view(np.uint32))


@pytest.mark.parametrize("dead_first", [False, True])
def test_watchdog_runs_match_reference(dead_first):
    out = {}
    for pkg in ("port", "ref"):
        system = _udp_pair(dead_first, pkg=pkg)
        results = system.run_rounds(6 if not dead_first else 4)
        out[pkg] = (records(results), system.global_params["w"])
    assert out["port"][0] == out["ref"][0]
    np.testing.assert_array_equal(out["port"][1], out["ref"][1])


@pytest.mark.parametrize("engine", ["per_packet", "batched"])
@pytest.mark.parametrize("transport", ["mudp", "udp", "mudp+fec"])
def test_async_fleet_bitwise_against_reference(consensus_fleet, engine,
                                               transport, monkeypatch):
    calls = []
    fedavg = fedavg_ops.fedavg
    monkeypatch.setattr(fedavg_ops, "fedavg",
                        lambda *a, **k: calls.append(1) or fedavg(*a, **k))
    kw = dict(n=24, rounds=8, seed=7, obj_params=256, mode="async",
              buffer_k=5, engine=engine, transport=transport,
              round_deadline_ns=4 * NS)
    _, sim_p, port, rp = port_consensus_fleet("star", **kw)
    _, sim_r, ref, rr = consensus_fleet("star", **kw)
    assert records(rp) == records(rr)
    assert sim_p.stats_digest() == sim_r.stats_digest()
    np.testing.assert_array_equal(port.global_params["w"].view(np.uint32),
                                  ref.global_params["w"].view(np.uint32))
    # Every flush folded its staleness-discounted rows through the
    # fedavg kernel's wrapper.
    assert len(calls) == len(rp) == 8
    assert any(r.late_folded for r in rp)
