"""The port's topology engine against the reference (the port's mirror of
``tests/test_topology.py``).

* Every case of the reference's file on the port: the registry, per-hop
  specs, star bit-identity with the hand-rolled historical wiring, hier's
  edge aggregation (dual address planes, round-robin cells, per-cell
  histories, an async root, per-hop pipelines) and serverless gossip.
* Parity: the same seeded consensus fleets through both packages under
  hier (sync and with an async root), gossip and star-async give equal
  round records and bitwise equal global parameters; ``neighbor_graph``
  is the reference's graph for every ``(n, k, seed)``.
* The pins ``chip_smoke.py`` holds on the card
  (``fleet_sim.PINNED_ARMS`` and ``PINNED_HIER_ADAPTIVE``) are the
  reference's live run of its example's arms, and the port reproduces
  them on the CPU.
* The topology gates of ``benchmarks/topology_bench.py``
  (``repro_torch.fleet_gates.topology_gate``) hold on the port.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import topology as ref_topology  # noqa: E402
from repro_torch import device as port_device  # noqa: E402
from repro_torch import fleet_gates, fleet_sim  # noqa: E402
from repro_torch.core import topology as port_topology  # noqa: E402
from repro_torch.core.fleet import (ConsensusObjective,  # noqa: E402
                                    FleetConfig, build_fleet, links_for,
                                    sample_profiles)
from repro_torch.core.rounds import (FederatedSystem, FLClient,  # noqa: E402
                                     FLConfig, TransportConfig)
from repro_torch.core.simulator import Simulator  # noqa: E402
from repro_torch.core.topology import (HierSystem, StarTopology,  # noqa: E402
                                       Topology, available_topologies,
                                       edge_client_addr, edge_server_addr,
                                       make_topology, neighbor_graph,
                                       register_topology, topology_hops)
from repro_torch.core.wire import WireError, parse_hop_specs  # noqa: E402
from repro_torch.kernels.fedavg import ops as fedavg_ops  # noqa: E402
from torch_fleet_arms import (port_consensus_fleet, records,  # noqa: E402
                              reference_run)


@pytest.fixture(autouse=True)
def _cpu():
    with port_device.use_device("cpu"):
        yield


# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------
def test_registry_lists_builtins():
    assert available_topologies() == ["gossip", "hier", "star"]
    assert isinstance(make_topology("star"), StarTopology)


def test_registry_unknown_name():
    with pytest.raises(ValueError, match="unknown topology.*'gossip', "
                                         "'hier', 'star'"):
        make_topology("mesh")


def test_registry_refuses_silent_shadowing():
    with pytest.raises(ValueError, match="already registered"):
        register_topology("star", StarTopology)


def test_topology_hops():
    assert topology_hops("star") == ("client->server", "server->client")
    for name in ("star", "hier", "gossip"):
        assert topology_hops(name) == ref_topology.topology_hops(name)


# --------------------------------------------------------------------------
# Per-hop wire spec parsing
# --------------------------------------------------------------------------
def test_parse_hop_specs():
    out = parse_hop_specs(
        "client->edge: topk(0.01)|int8(1024); edge->root: delta",
        known_hops=topology_hops("hier"))
    assert out == {"client->edge": "topk(0.01)|int8(1024)",
                   "edge->root": "delta"}


@pytest.mark.parametrize("spec", [
    "",                                     # empty
    "client->edge",                         # no pipeline
    "client->edge: raw; client->edge: hex",  # duplicate hop
    "client->edge: not_a_stage",            # bad pipeline
    "nope->where: raw",                     # unknown hop
])
def test_parse_hop_specs_rejects(spec):
    with pytest.raises(WireError):
        parse_hop_specs(spec, known_hops=topology_hops("hier"))


# --------------------------------------------------------------------------
# star: bit-identical to the historical wiring
# --------------------------------------------------------------------------
def test_star_bit_identical_to_historical_wiring(params_digest):
    n, rounds = 12, 3
    obj = ConsensusObjective(n, 48, seed=3)
    fleet = FleetConfig(n_clients=n, seed=7)
    base_cfg = FLConfig(transport=TransportConfig(kind="mudp"))

    # The pre-topology-engine build_fleet body.
    profiles = sample_profiles(fleet)
    fl_cfg = dataclasses.replace(
        base_cfg,
        participation_fraction=fleet.participation_fraction,
        min_participants=fleet.min_participants,
        participation_seed=fleet.seed,
        round_deadline_ns=fleet.round_deadline_ns,
        mode=fleet.mode,
        buffer_k=fleet.buffer_k)
    sim_old = Simulator(engine=fleet.engine)
    clients = []
    for i, p in enumerate(profiles):
        up, down = links_for(p)
        sim_old.connect(p.addr, fleet.server_addr, up, down)
        clients.append(FLClient(p.addr, obj.train_fn(i, p),
                                train_time_ns=p.train_time_ns,
                                weight=p.weight, cadence_ns=p.cadence_ns))
    old = FederatedSystem(sim_old, fleet.server_addr, clients,
                          obj.init_params(), fl_cfg)
    old_results = old.run_rounds(rounds)

    sim_new, new, _ = build_fleet(fleet, obj.init_params(),
                                  lambda i, p: obj.train_fn(i, p), base_cfg)
    new_results = new.run_rounds(rounds)

    assert params_digest(new.global_params) == \
        params_digest(old.global_params)
    assert sim_new.stats_digest() == sim_old.stats_digest()
    for a, b in zip(old_results, new_results):
        assert (a.arrived, a.failed, a.bytes_sent, a.duration_ns) == \
            (b.arrived, b.failed, b.bytes_sent, b.duration_ns)


def test_star_hop_counters_cover_all_traffic():
    _, sim, _, _ = port_consensus_fleet("star")
    assert set(sim.hop_bytes) == {"client->server", "server->client"}
    assert sum(sim.hop_bytes.values()) == sim.stats["bytes_sent"]
    assert sum(sim.hop_packets.values()) == sim.stats["packets_sent"]


# --------------------------------------------------------------------------
# hier: edge aggregation
# --------------------------------------------------------------------------
def test_hier_matches_star_final_model():
    obj_s, _, star, _ = port_consensus_fleet("star", n=16)
    obj_h, _, hier, _ = port_consensus_fleet("hier", n=16, cells=4)
    np.testing.assert_allclose(hier.global_params["w"],
                               star.global_params["w"],
                               rtol=1e-5, atol=1e-6)
    assert abs(obj_h.loss(hier.global_params)
               - obj_s.loss(star.global_params)) < 1e-6


def test_hier_root_link_smaller_than_star():
    _, sim_s, _, _ = port_consensus_fleet("star", n=16)
    _, sim_h, _, _ = port_consensus_fleet("hier", n=16, cells=4)
    assert sim_h.hop_bytes["edge->root"] < sim_s.hop_bytes["client->server"]
    assert set(sim_h.hop_bytes) == {"client->edge", "edge->client",
                                    "edge->root", "root->edge"}
    assert sum(sim_h.hop_bytes.values()) == sim_h.stats["bytes_sent"]


def test_hier_cell_assignment_round_robin():
    fleet = FleetConfig(n_clients=10, topology="hier", cells=3)
    assert [fleet.cell_of(i) for i in range(6)] == [0, 1, 2, 0, 1, 2]
    _, _, hier, _ = port_consensus_fleet("hier", n=10, cells=3, rounds=1)
    assert isinstance(hier, HierSystem)
    sizes = sorted(len(e.core.pool.clients) for e in hier.edges)
    assert sizes == [3, 3, 4]
    for e in hier.edges:
        for addr in e.core.pool.clients:
            assert hier.edge_for(addr) is e


def test_hier_addresses_are_dual_plane():
    _, sim, hier, _ = port_consensus_fleet("hier", n=8, cells=2, rounds=1)
    for m, e in enumerate(hier.edges):
        assert e.addr == edge_client_addr(m) == ref_topology.edge_client_addr(m)
        assert e.server_addr == edge_server_addr(m) == \
            ref_topology.edge_server_addr(m)
        assert e.addr != e.server_addr


def test_hier_per_cell_histories_advance():
    _, _, hier, results = port_consensus_fleet("hier", n=16, cells=4,
                                               rounds=3)
    assert len(results) == 3
    for e in hier.edges:
        assert len(e.core.history) == 3


def test_hier_async_root():
    _, sim, hier, results = port_consensus_fleet(
        "hier", n=16, cells=4, rounds=3, mode="async", buffer_k=4,
        round_deadline_ns=120_000_000_000)
    assert len(results) == 3
    assert sim.hop_bytes["edge->root"] > 0
    assert hier.root.scheduler.mode == "async"


def test_hier_cell_scheduler_refuses_direct_drive():
    _, _, hier, _ = port_consensus_fleet("hier", n=8, cells=2, rounds=1)
    with pytest.raises(RuntimeError, match="parent tier"):
        hier.edges[0].scheduler.run_round()
    with pytest.raises(RuntimeError, match="parent tier"):
        hier.edges[0].scheduler.run_rounds(2)


def test_hier_per_hop_pipeline_specs():
    _, sim, _, _ = port_consensus_fleet(
        "hier", n=16, cells=4,
        hops="client->edge: int8(48); edge->root: raw")
    plain = port_consensus_fleet("hier", n=16, cells=4)[1]
    assert sim.hop_bytes["client->edge"] < plain.hop_bytes["client->edge"]


def test_hier_edges_fold_through_the_fedavg_kernel(monkeypatch):
    """Each cell's aggregation and the root's run through the fedavg
    kernel's wrapper (on the card: the kernel)."""
    calls = []
    fedavg = fedavg_ops.fedavg
    monkeypatch.setattr(fedavg_ops, "fedavg",
                        lambda s, w: calls.append(tuple(s.shape)) or
                        fedavg(s, w))
    _, _, hier, results = port_consensus_fleet("hier", n=12, cells=3,
                                               rounds=2)
    assert len(calls) == 2 * (3 + 1)            # 3 cells + the root a round
    assert sorted({k for k, _ in calls}) == [3, 4]


# --------------------------------------------------------------------------
# gossip: serverless
# --------------------------------------------------------------------------
def test_neighbor_graph_connected_and_seeded():
    adj = neighbor_graph(20, 4, seed=1)
    assert adj == neighbor_graph(20, 4, seed=1)
    assert all(len(a) >= 4 for a in adj)
    assert all(i not in adj[i] for i in range(20))
    for i in range(20):
        for j in adj[i]:
            assert i in adj[j]
    seen, stack = {0}, [0]
    while stack:
        for j in adj[stack.pop()]:
            if j not in seen:
                seen.add(j)
                stack.append(j)
    assert len(seen) == 20


@pytest.mark.parametrize("n,k,seed", [(2, 1, 0), (12, 3, 7), (20, 4, 1),
                                      (48, 4, 7), (64, 4, 0), (97, 9, 12345)])
def test_neighbor_graph_is_the_reference_graph(n, k, seed):
    assert neighbor_graph(n, k, seed) == ref_topology.neighbor_graph(
        n, k, seed)


def test_neighbor_graph_needs_two_clients():
    with pytest.raises(ValueError, match="at least 2"):
        neighbor_graph(1, 1, 0)


def test_gossip_has_zero_server_nodes():
    fleet_server = FleetConfig(n_clients=12, topology="gossip",
                               neighbors=3).server_addr
    _, sim, system, results = port_consensus_fleet("gossip", n=12,
                                                   neighbors=3)
    assert fleet_server not in sim._nodes
    assert set(sim.hop_bytes) == {"peer->peer"}
    assert sim.hop_bytes["peer->peer"] == sim.stats["bytes_sent"]
    assert results[-1].metrics["neighbors_mean"] > 0


def test_gossip_converges_and_is_deterministic(params_digest):
    obj1, _, s1, _ = port_consensus_fleet("gossip", n=12, neighbors=3,
                                          rounds=4)
    obj2, _, s2, _ = port_consensus_fleet("gossip", n=12, neighbors=3,
                                          rounds=4)
    assert params_digest(s1.global_params) == params_digest(s2.global_params)
    initial = obj1.loss({"w": np.zeros(48, np.float32)})
    assert obj1.loss(s1.global_params) < 0.5 * initial


def test_gossip_rejects_delta_pipelines():
    obj = ConsensusObjective(8, 16, seed=0)
    fleet = FleetConfig(n_clients=8, topology="gossip", neighbors=2,
                        hops="peer->peer: delta|int8(1024)")
    with pytest.raises(ValueError, match="delta|weight-domain"):
        build_fleet(fleet, obj.init_params(),
                    lambda i, p: obj.train_fn(i, p),
                    FLConfig(transport=TransportConfig(kind="mudp")))


def test_gossip_runs_on_the_flow_engine_as_the_reference():
    """Gossip refused the flow engine until its slice was ported; now its
    peer exchange runs through the analytic transport models, bitwise as
    the reference's gossip does."""
    from repro.core import fleet as ref_fleet
    from repro.core import rounds as ref_rounds
    from repro_torch.core import fleet as port_fleet
    from repro_torch.core import rounds as port_rounds

    def run(fleet_mod, rounds_mod):
        obj = fleet_mod.ConsensusObjective(8, 16, seed=0)
        fleet = fleet_mod.FleetConfig(n_clients=8, topology="gossip",
                                      neighbors=2, engine="flow")
        sim, system, _ = fleet_mod.build_fleet(
            fleet, obj.init_params(), lambda i, p: obj.train_fn(i, p),
            rounds_mod.FLConfig(transport=rounds_mod.TransportConfig(
                kind="mudp")))
        results = system.run_rounds(2)
        return (records(results), dict(sim.stats), dict(sim.hop_bytes),
                np.asarray(system.global_params["w"]).tobytes())
    got = run(port_fleet, port_rounds)
    assert got == run(ref_fleet, ref_rounds)
    assert got[2]["peer->peer"] > 0


# --------------------------------------------------------------------------
# FleetConfig validation (fail at construction, not deep in build)
# --------------------------------------------------------------------------
@pytest.mark.parametrize("kw,match", [
    (dict(topology="mesh"), "unknown topology"),
    (dict(topology="hier", cells=0), "cells"),
    (dict(topology="hier", cells=17), "cannot exceed"),
    (dict(topology="hier", edge_cohort="dialup"), "edge_cohort"),
    (dict(topology="hier", cell_transport="pigeon"), "transport"),
    (dict(topology="gossip", neighbors=0), "degree"),
    (dict(topology="gossip", neighbors=16), "must be <"),
    (dict(hops="client->server: bogus_stage"), "invalid hops"),
    (dict(hops="peer->peer: raw"), "invalid hops"),   # not a star hop
    (dict(hops="client->server: raw", uplink="raw"), "two spellings"),
    (dict(n_clients=0), "n_clients"),
])
def test_fleetconfig_validation(kw, match):
    base = dict(n_clients=16)
    base.update(kw)
    with pytest.raises(ValueError, match=match):
        FleetConfig(**base)


def test_custom_topology_plugs_in():
    class NullTopology(Topology):
        name = "null"
        hops = ()

        def build(self, fleet, profiles, global_params, train_fn_factory,
                  fl_cfg):
            return Simulator(), None

    register_topology("null", NullTopology, overwrite=True)
    try:
        fleet = FleetConfig(n_clients=2, topology="null")
        sim, system, profiles = build_fleet(fleet, {"w": np.zeros(4)},
                                            lambda i, p: None)
        assert system is None and len(profiles) == 2
    finally:
        del port_topology._REGISTRY["null"]


# --------------------------------------------------------------------------
# Parity with the reference
# --------------------------------------------------------------------------
@pytest.mark.parametrize("topology,kw", [
    ("hier", dict(cells=4)),
    ("hier", dict(cells=3, mode="async", buffer_k=3,
                  round_deadline_ns=8_000_000_000)),
    ("hier", dict(cells=2, cell_transport="udp", edge_cohort="lte",
                  hops="client->edge: int8(16); edge->root: raw")),
    ("gossip", dict(neighbors=3)),
    ("gossip", dict(neighbors=5, hops="peer->peer: int8(16)")),
    ("star", dict(mode="async", buffer_k=4, round_deadline_ns=4_000_000_000)),
])
def test_consensus_fleets_bitwise_against_reference(consensus_fleet,
                                                    topology, kw):
    fleet_kw = dict(n=16, rounds=4, seed=7, **kw)
    _, sim_p, port, rp = port_consensus_fleet(topology, **fleet_kw)
    _, sim_r, ref, rr = consensus_fleet(topology, **fleet_kw)
    assert records(rp) == records(rr)
    assert dict(sim_p.hop_bytes) == dict(sim_r.hop_bytes)
    np.testing.assert_array_equal(port.global_params["w"].view(np.uint32),
                                  ref.global_params["w"].view(np.uint32))
    if topology == "hier":
        for ep, er in zip(port.edges, ref.edges):
            assert records(ep.core.history) == records(er.core.history)


@pytest.mark.parametrize("arm", sorted(fleet_sim.PINNED_ARMS))
def test_pinned_consensus_arms(arm):
    """Each pin is the reference's live run of its example's arm, and the
    port reproduces it, SHA-256 of the final global parameters included."""
    topology, mode, transport = arm
    pin = fleet_sim.PINNED_ARMS[arm]
    kw = dict(model="consensus", control="static", topology=topology,
              mode=mode)
    ref_build, ref_recs = reference_run(transport, **kw)
    assert fleet_sim.pinned_view(ref_recs) == {"hops": pin["hops"],
                                               "rounds": pin["rounds"]}
    assert fleet_sim.params_sha256(ref_build.system.global_params) == \
        pin["sha256"]
    build = fleet_sim.build(transport, device="cpu", **kw)
    recs = fleet_sim.run_rounds(build, fleet_sim.rounds_for(mode))
    assert fleet_sim.pinned_view(recs) == {"hops": pin["hops"],
                                           "rounds": pin["rounds"]}
    assert fleet_sim.params_sha256(build.system.global_params) == \
        pin["sha256"]


def test_pinned_mlp_hier_adaptive_arm():
    kw = dict(model="mlp", control="adaptive", topology="hier", mode="sync")
    _, ref_recs = reference_run("mudp+fec", **kw)
    assert fleet_sim.pinned_view(ref_recs) == fleet_sim.PINNED_HIER_ADAPTIVE
    recs = fleet_sim.run_rounds(
        fleet_sim.build("mudp+fec", device="cpu", **kw), fleet_sim.ROUNDS)
    assert fleet_sim.pinned_view(recs) == fleet_sim.PINNED_HIER_ADAPTIVE
    assert recs[-1]["accuracy"] > recs[0]["accuracy"]


def test_topology_gates_hold():
    results, failures = fleet_gates.topology_gate(clients=32, cells=(2, 4))
    assert failures == []
    assert results["gossip_k4"]["server_nodes"] == 0
