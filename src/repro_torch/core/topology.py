"""Topology engine: how a fleet is *wired*, as a pluggable policy.

The paper validates MUDP on a 3-node star and defers "a larger Federated
learning system".  This module makes the wiring a registry-keyed
abstraction — the same idiom as transports
(``repro_torch.core.transport``) and wire stages
(``repro_torch.core.wire``) — with the reference's three built-ins:

* ``star`` — the paper's topology, wired exactly as the reference's
  ``star`` (same link draws, same construction order, same FLConfig
  overrides).
* ``hier`` — a two-tier tree: clients are partitioned into *cells*, each
  served by an **edge aggregator** that runs a local FedAvg round over its
  cell through a nested :class:`~repro_torch.core.server.ServerCore` and
  forwards one merged, weight-carrying update upstream.  The root link
  carries O(aggregators) traffic instead of O(clients).  The root tier is
  a regular :class:`~repro_torch.core.rounds.FederatedSystem`, so sync
  *and* async scheduling both work above the edges unchanged.
* ``gossip`` — serverless peer-to-peer federation (PeerFL-style): clients
  exchange updates over the existing Transport API on a seeded neighbor
  graph and mix locally; there is no server node anywhere in the
  simulation.  The mixing is host numpy in float32, as in the reference.

Every *hop* composes independently with the wire plane: a topology
publishes its hop names (``Topology.hops``) and ``FleetConfig.hops``
carries per-hop pipeline specs, e.g. ::

    FleetConfig(topology="hier", cells=8,
                hops="client->edge: topk(0.01)|int8(1024); "
                     "edge->root: delta")

Per-hop traffic is accounted by :meth:`Simulator.label_hop`
(``sim.hop_bytes``), which is how the topology gate
(:mod:`repro_torch.fleet_gates`) shows the root link shrinking ~linearly
in aggregator count.
"""

from __future__ import annotations

import abc
import dataclasses
import random
from typing import Any, Callable, Optional

import numpy as np

from repro_torch import device as _device
from repro_torch.core.packetizer import (flatten_to_vector, packetize,
                                         unflatten_from_vector)
from repro_torch.core.rounds import FederatedSystem, FLClient, FLConfig
from repro_torch.core.scheduling import SyncScheduler
from repro_torch.core.server import (TRAINING, ClientSession, RoundResult,
                                     ServerCore)
from repro_torch.core.simulator import Simulator
from repro_torch.core.transport import Transport, make_transport
from repro_torch.core.wire import (Pipeline, WireDecodeError,
                                   decode_payload as wire_decode_payload,
                                   legacy_pipeline, parse_hop_specs,
                                   parse_pipeline)


# --------------------------------------------------------------------------
# The abstraction + registry
# --------------------------------------------------------------------------
class Topology(abc.ABC):
    """How profiles become a wired simulator + a runnable federation.

    ``hops`` are the directed link classes this topology creates; each may
    carry its own wire-pipeline spec (``FleetConfig.hops``).
    ``uplink_hop`` / ``downlink_hop`` name the hops the legacy
    ``FleetConfig.uplink`` / ``downlink`` shorthands map onto.
    """

    name: str = "abstract"
    hops: tuple[str, ...] = ()
    uplink_hop: Optional[str] = None
    downlink_hop: Optional[str] = None

    @abc.abstractmethod
    def build(self, fleet, profiles: list, global_params: Any,
              train_fn_factory: Callable, fl_cfg: Optional[FLConfig]
              ) -> tuple[Simulator, Any]:
        """Wire ``profiles`` into a fresh Simulator and return
        ``(sim, system)`` where ``system`` has the FederatedSystem run
        surface (``run_round`` / ``run_rounds`` / ``global_params`` /
        ``history`` / ``on_round_end``)."""


_REGISTRY: dict[str, Callable[[], Topology]] = {}


def register_topology(name: str, factory: Callable[[], Topology], *,
                      overwrite: bool = False) -> None:
    """Register ``factory`` under ``name`` (the transport-registry idiom:
    silent shadowing of a built-in would invalidate benchmarks)."""
    if not overwrite and name in _REGISTRY:
        raise ValueError(f"topology {name!r} is already registered "
                         f"(pass overwrite=True to replace it)")
    _REGISTRY[name] = factory


def make_topology(name: str) -> Topology:
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown topology {name!r}; registered topologies: "
            f"{available_topologies()}") from None
    return factory()


def available_topologies() -> list[str]:
    return sorted(_REGISTRY)


def topology_hops(name: str) -> tuple[str, ...]:
    """The hop names ``name`` wires (for per-hop spec validation)."""
    return make_topology(name).hops


def resolved_hop_specs(fleet, topo: Topology) -> dict[str, str]:
    """Merge ``fleet.hops`` with the legacy ``uplink``/``downlink``
    shorthands into one ``{hop: pipeline spec}`` map for ``topo``.
    ``FleetConfig`` already rejects setting both spellings at once."""
    out: dict[str, str] = {}
    if fleet.hops is not None:
        out = parse_hop_specs(fleet.hops, known_hops=topo.hops)
    if fleet.uplink is not None:
        if topo.uplink_hop is None:
            raise ValueError(f"topology {topo.name!r} has no uplink hop; "
                             f"use hops= with one of {sorted(topo.hops)}")
        out[topo.uplink_hop] = fleet.uplink
    if fleet.downlink is not None:
        if topo.downlink_hop is None:
            raise ValueError(f"topology {topo.name!r} has no downlink hop; "
                             f"use hops= with one of {sorted(topo.hops)}")
        out[topo.downlink_hop] = fleet.downlink
    return out


# --------------------------------------------------------------------------
# star — the paper's wiring, as the reference's
# --------------------------------------------------------------------------
class StarTopology(Topology):
    """N clients around one server: the reference's ``star`` wiring (same
    link draws, same construction order, same FLConfig overrides)."""

    name = "star"
    hops = ("client->server", "server->client")
    uplink_hop = "client->server"
    downlink_hop = "server->client"

    def build(self, fleet, profiles, global_params, train_fn_factory,
              fl_cfg):
        from repro_torch.core.fleet import links_for
        fl_cfg = fl_cfg if fl_cfg is not None else FLConfig()
        hop = resolved_hop_specs(fleet, self)
        transport = fl_cfg.transport
        up, down = hop.get(self.uplink_hop), hop.get(self.downlink_hop)
        if up is not None or down is not None:
            transport = dataclasses.replace(
                transport,
                uplink=up if up is not None else transport.uplink,
                downlink=down if down is not None else transport.downlink)
        fl_cfg = dataclasses.replace(
            fl_cfg,
            transport=transport,
            participation_fraction=fleet.participation_fraction,
            min_participants=fleet.min_participants,
            participation_seed=fleet.seed,
            round_deadline_ns=fleet.round_deadline_ns,
            mode=fleet.mode,
            buffer_k=fleet.buffer_k,
            batch_wire=fleet.batch_wire,
            control=fleet.control,
            control_args=fleet.control_args,
        )
        sim = Simulator(engine=fleet.engine)
        clients = []
        for i, p in enumerate(profiles):
            up_l, down_l = links_for(p)
            sim.connect(p.addr, fleet.server_addr, up_l, down_l)
            sim.label_hop(p.addr, fleet.server_addr, self.uplink_hop)
            sim.label_hop(fleet.server_addr, p.addr, self.downlink_hop)
            clients.append(FLClient(p.addr, train_fn_factory(i, p),
                                    train_time_ns=p.train_time_ns,
                                    weight=p.weight,
                                    cadence_ns=p.cadence_ns))
        system = FederatedSystem(sim, fleet.server_addr, clients,
                                 global_params, fl_cfg)
        return sim, system


# --------------------------------------------------------------------------
# hier — two-tier tree with edge aggregators
# --------------------------------------------------------------------------
def edge_server_addr(m: int) -> str:
    """The edge's cell-facing (server-plane) address."""
    return f"10.2.0.{m + 1}"


def edge_client_addr(m: int) -> str:
    """The edge's root-facing (client-plane) address.  Separate from the
    server plane because persistent receivers consume every DATA packet on
    their node: one node cannot host both the cell's server receiver and
    the edge's root-downlink receiver."""
    return f"10.3.0.{m + 1}"


def _edge_train_stub(params, round_idx, client):
    raise RuntimeError("edge aggregators do not run local training; their "
                       "'training' step is the nested cell round "
                       "(ServerCore.train_override)")


class CellScheduler(SyncScheduler):
    """The sync barrier, driven by callbacks instead of ``sim.run()``.

    The edge tier runs one of these per cell *concurrently over one
    simulator*, so the barrier cannot own the event loop the way
    ``SyncScheduler.run_round`` does.  ``start_round`` opens the barrier
    (session-scoped txn pair — many cells overlap in flight); when it
    resolves (every sampled cell client resolved, or the cell deadline
    fires) the aggregated :class:`RoundResult` is emitted into the cell
    core's history and handed to ``on_complete``.
    """

    mode = "cell"

    def __init__(self, core: ServerCore):
        super().__init__(core)
        self._on_complete: Optional[Callable[[RoundResult], None]] = None

    def start_round(self, params: Any,
                    on_complete: Callable[[RoundResult], None]) -> None:
        if self._round_open:
            # Superseded: an async root watchdog re-entered the edge while
            # the previous cell round was still in flight.  Abandon the old
            # barrier; its straggler uplinks fold into the next round's
            # late buffer like any other cutoff.
            self._abandon()
        self.core.global_params = params
        self._on_complete = on_complete
        # clear_sessions=False: previous cell rounds' sessions stay
        # registered so their straggler uplinks reach on_uplink (-> late
        # buffer) instead of vanishing; resolved sessions are dropped
        # eagerly below, bounding the registries.
        self._begin_round(None, txn_pair=self.core.new_txn_pair(),
                          clear_sessions=False)
        if self._round_open and not self._roster:
            # Every cell client is benched: resolve immediately so the
            # parent barrier is never held hostage by an empty cell.
            self._finalize()

    def _abandon(self) -> None:
        self._round_open = False
        if self._deadline_timer is not None:
            self._deadline_timer.cancel()
            self._deadline_timer = None
        self._on_complete = None

    def _finalize(self) -> None:
        super()._finalize()
        cb, self._on_complete = self._on_complete, None
        result = self.core.emit_result(self._build_result())
        if cb is not None:
            cb(result)

    # Resolved sessions are dropped eagerly: cell rounds never call
    # clear_sessions() between rounds (the registries would otherwise grow
    # with every overlapping round), and a receiver delivers each txn
    # exactly once so a resolved session can never match traffic again.
    def on_uplink(self, session, addr, txn, vec) -> None:
        super().on_uplink(session, addr, txn, vec)
        if session is not None:
            self.core.drop_session(session)

    def on_session_failed(self, session) -> None:
        if session.round_idx != self._round_idx:
            # A sender of an earlier (abandoned or finalized) cell round
            # exhausted its retries mid-overlap.  SyncScheduler keys
            # failures by address, so without this guard the stale failure
            # would resolve the client's *current* session as failed.
            self.core.drop_session(session)
            return
        super().on_session_failed(session)
        self.core.drop_session(session)

    def run_round(self, round_idx=None):
        raise RuntimeError("cell rounds are driven by the parent tier; "
                           "use start_round()")

    def run_rounds(self, n):
        raise RuntimeError("cell rounds are driven by the parent tier; "
                           "use start_round()")


class EdgeAggregator:
    """One cell's aggregator: a nested ServerCore + cell barrier on the
    server plane, an FLClient of the root tier on the client plane."""

    def __init__(self, idx: int, client: FLClient, core: ServerCore,
                 scheduler: CellScheduler):
        self.idx = idx
        self.client = client          # root-facing identity
        self.core = core              # cell-facing ServerCore
        self.scheduler = scheduler

    @property
    def addr(self) -> str:
        return self.client.addr

    @property
    def server_addr(self) -> str:
        return self.core.server_addr


class HierSystem:
    """The FederatedSystem surface over a two-tier tree.

    The *root* is a regular :class:`FederatedSystem` whose clients are the
    edge aggregators; its core's ``train_override`` turns each edge's
    "training" step into a full nested cell round:

        root downlink -> edge -> cell broadcast -> cell barrier ->
        local FedAvg -> one merged update (weight = arrived cell mass)
        -> edge uplink -> root aggregation

    ``run_round`` / ``run_rounds`` / ``global_params`` / ``history`` /
    ``on_round_end`` delegate to the root, so benchmarks and examples
    treat a tree exactly like a star.  Per-cell round histories live on
    each edge's nested core (``edges[m].core.history``).
    """

    def __init__(self, sim: Simulator, root: FederatedSystem,
                 edges: list[EdgeAggregator]):
        self.sim = sim
        self.root = root
        self.edges = edges
        self._by_addr = {e.addr: e for e in edges}
        root.core.train_override = self._on_edge_model

    # -- the nested-round train override --------------------------------------
    def _on_edge_model(self, session: ClientSession) -> None:
        """Root downlink delivered to an edge: run its cell round; the
        merged model uplinks when the cell barrier resolves."""
        edge = self._by_addr[session.addr]
        session.state = TRAINING
        received = session.client.params

        def _cell_done(result: RoundResult) -> None:
            merged = edge.core.global_params
            weight = 0.0
            for addr in result.arrived:
                c = edge.core.pool.clients.get(addr)
                if c is not None:
                    weight += c.weight
            # The merged update carries the cell's arrived mass upstream so
            # root FedAvg over edges equals client-weighted FedAvg over the
            # union.  An empty-handed cell forwards its unchanged model
            # with weight 0 (dropped by apply_aggregation) so the root
            # barrier still resolves.
            session.client.weight = weight
            self.root.core.uplink_update(session, received, merged)

        edge.scheduler.start_round(received, _cell_done)

    # -- the stable surface ---------------------------------------------------
    def run_round(self, round_idx: Optional[int] = None) -> RoundResult:
        return self.root.run_round(round_idx)

    def run_rounds(self, n: int) -> list[RoundResult]:
        return self.root.run_rounds(n)

    @property
    def global_params(self) -> Any:
        return self.root.global_params

    @global_params.setter
    def global_params(self, value: Any) -> None:
        self.root.global_params = value

    @property
    def history(self) -> list[RoundResult]:
        return self.root.history

    @property
    def on_round_end(self):
        return self.root.on_round_end

    @on_round_end.setter
    def on_round_end(self, cb) -> None:
        self.root.on_round_end = cb

    @property
    def pool(self):
        return self.root.pool

    @property
    def device(self):
        """The device the root's rounds (and the nested cell rounds they
        drive) run their array work on."""
        return self.root.device

    @device.setter
    def device(self, value) -> None:
        self.root.device = value

    def edge_for(self, client_addr: str) -> Optional[EdgeAggregator]:
        for e in self.edges:
            if client_addr in e.core.pool.clients:
                return e
        return None


class HierTopology(Topology):
    """Two-tier tree: ``cells`` edge aggregators between the clients and
    the root.  Cell membership is round-robin (``FleetConfig.cell_of``) so
    every cell gets the same cohort mix; edge<->root links are drawn from
    ``FleetConfig.edge_cohort`` (default ``fiber`` — aggregators are
    infrastructure, not phones) on their own RNG stream, so client link
    draws stay bit-identical to the star's."""

    name = "hier"
    hops = ("client->edge", "edge->client", "edge->root", "root->edge")
    uplink_hop = "edge->root"
    downlink_hop = "root->edge"

    def build(self, fleet, profiles, global_params, train_fn_factory,
              fl_cfg):
        from repro_torch.core.fleet import links_for
        fl_cfg = fl_cfg if fl_cfg is not None else FLConfig()
        hop = resolved_hop_specs(fleet, self)
        cells = fleet.cells
        base_t = fl_cfg.transport

        root_transport = dataclasses.replace(
            base_t,
            uplink=hop.get("edge->root"),
            downlink=hop.get("root->edge"))
        root_cfg = dataclasses.replace(
            fl_cfg,
            transport=root_transport,
            participation_fraction=1.0,    # the root always serves every edge
            min_participants=1,
            participation_seed=fleet.seed,
            # The deadline knob bounds the *cell* round; the root tier gets
            # double the budget so a cell that used its whole allowance
            # (straggler cutoff at exactly the deadline) can still uplink
            # its merged update before the root barrier closes.
            round_deadline_ns=(None if fleet.round_deadline_ns is None
                               else 2 * fleet.round_deadline_ns),
            mode=fleet.mode,
            # An async root can never buffer more than one update per edge
            # in a window, so a star-calibrated buffer_k would stall.
            buffer_k=min(fleet.buffer_k, cells),
            batch_wire=fleet.batch_wire,
            control=fleet.control,
            control_args=fleet.control_args,
        )
        cell_transport = dataclasses.replace(
            base_t,
            kind=fleet.cell_transport if fleet.cell_transport is not None
            else base_t.kind,
            uplink=hop.get("client->edge"),
            downlink=hop.get("edge->client"))

        sim = Simulator(engine=fleet.engine)
        edge_profs = sample_edge_profiles(fleet, cells)
        for m in range(cells):
            up_l, down_l = links_for(edge_profs[m])
            sim.connect(edge_profs[m].addr, fleet.server_addr, up_l, down_l)
            sim.label_hop(edge_profs[m].addr, fleet.server_addr,
                          "edge->root")
            sim.label_hop(fleet.server_addr, edge_profs[m].addr,
                          "root->edge")
        cell_members: list[list[tuple[int, Any]]] = [[] for _ in range(cells)]
        for i, p in enumerate(profiles):
            m = fleet.cell_of(i)
            up_l, down_l = links_for(p)
            sim.connect(p.addr, edge_server_addr(m), up_l, down_l)
            sim.label_hop(p.addr, edge_server_addr(m), "client->edge")
            sim.label_hop(edge_server_addr(m), p.addr, "edge->client")
            cell_members[m].append((i, p))

        edges: list[EdgeAggregator] = []
        root_clients: list[FLClient] = []
        for m in range(cells):
            cell_cfg = dataclasses.replace(
                fl_cfg,
                transport=cell_transport,
                mode="sync",               # the cell barrier is CellScheduler
                participation_fraction=fleet.participation_fraction,
                min_participants=fleet.min_participants,
                # Distinct per-cell stream (ints only: Random.random()-level
                # stability); one shared seed would correlate roster draws.
                participation_seed=fleet.seed * 1009 + m + 1,
                round_deadline_ns=fleet.round_deadline_ns,
                batch_wire=fleet.batch_wire,
                # Per-hop policies: each cell's ServerCore runs its own
                # controller instance over its own clients' telemetry, and
                # the root runs one over the edge uplinks (root_cfg above).
                control=fleet.control,
                control_args=fleet.control_args,
            )
            cell_clients = [
                FLClient(p.addr, train_fn_factory(i, p),
                         train_time_ns=p.train_time_ns,
                         weight=p.weight,
                         cadence_ns=p.cadence_ns)
                for i, p in cell_members[m]]
            core = ServerCore(sim, edge_server_addr(m), cell_clients,
                              global_params, cell_cfg)
            scheduler = CellScheduler(core)
            edge_client = FLClient(edge_profs[m].addr, _edge_train_stub,
                                   train_time_ns=0, weight=1.0,
                                   cadence_ns=0)
            edges.append(EdgeAggregator(m, edge_client, core, scheduler))
            root_clients.append(edge_client)

        root = FederatedSystem(sim, fleet.server_addr, root_clients,
                               global_params, root_cfg)
        return sim, HierSystem(sim, root, edges)


def sample_edge_profiles(fleet, cells: int) -> list:
    """Deterministic edge<->root link draws from ``fleet.edge_cohort``.

    A dedicated RNG stream (like the cadence draws in
    ``sample_profiles``): adding aggregators must not re-roll any client's
    link profile for a given seed.
    """
    from repro_torch.core.fleet import ClientProfile
    spec = fleet.cohort_specs()[fleet.edge_cohort]
    rng = random.Random(hash((int(fleet.seed), 0xED6E)))

    def u(lo: float, hi: float) -> float:
        return lo + (hi - lo) * rng.random()

    out = []
    for m in range(cells):
        up = u(*spec.up_rate_bps)
        delay = int(u(*spec.delay_ns))
        out.append(ClientProfile(
            addr=edge_client_addr(m),
            cohort=spec.name,
            up_rate_bps=up,
            down_rate_bps=up * spec.down_up_ratio,
            delay_ns=delay,
            jitter_ns=int(spec.jitter_frac * delay),
            loss_p=u(*spec.loss_p),
            bursty=spec.bursty,
            train_time_ns=0,
            weight=1.0,
            # Offset past every client link seed for this fleet seed.
            seed=int(fleet.seed) * 1_000_003 + (fleet.n_clients + m) * 4,
            cadence_ns=0,
        ))
    return out


# --------------------------------------------------------------------------
# gossip — serverless peer-to-peer federation
# --------------------------------------------------------------------------
def neighbor_graph(n: int, k: int, seed: int) -> list[set[int]]:
    """A seeded, connected, roughly ``k``-regular undirected graph.

    A ring guarantees connectivity; seeded chords (``Random.random()``
    only, so the draw is bit-stable across Python versions) raise every
    node's degree to at least ``min(k, n-1)``.
    """
    if n < 2:
        raise ValueError("a gossip graph needs at least 2 clients")
    adj: list[set[int]] = [set() for _ in range(n)]
    for i in range(n):
        j = (i + 1) % n
        if i != j:
            adj[i].add(j)
            adj[j].add(i)
    rng = random.Random(hash((int(seed), 0x605519)))
    for i in range(n):
        want = min(k, n - 1)
        attempts = 0
        while len(adj[i]) < want and attempts < 64 * n:
            j = int(rng.random() * n)
            attempts += 1
            if j != i and j not in adj[i]:
                adj[i].add(j)
                adj[j].add(i)
    return adj


class GossipSystem:
    """Serverless federation over a fixed neighbor graph.

    Each round every client trains locally, ships its model to its
    neighbors through the regular Transport API (MUDP NACK-repair, UDP
    zero-fill, FEC — all of it works peer-to-peer unchanged), and mixes
    whatever arrived with its own model, weighted by the senders'
    aggregation mass.  ``global_params`` is the *evaluation* consensus
    (weighted mean over client models); it never travels on the wire and
    there is no server node in the simulation.
    """

    def __init__(self, sim: Simulator, profiles: list,
                 adj: list[set[int]], global_params: Any,
                 train_fn_factory: Callable, cfg: FLConfig,
                 pipeline: Pipeline):
        self.sim = sim
        self.cfg = cfg
        self.adj = adj
        self.pipeline = pipeline
        self.transport: Transport = make_transport(cfg.transport.kind)
        self.clients = [
            FLClient(p.addr, train_fn_factory(i, p),
                     train_time_ns=p.train_time_ns, weight=p.weight)
            for i, p in enumerate(profiles)]
        for c in self.clients:
            c.params = global_params
        self._template = global_params
        self._n_params = int(flatten_to_vector(global_params).size)
        self._addr_idx = {c.addr: i for i, c in enumerate(self.clients)}
        # Per-client mailbox: sender index -> decoded vector, cleared at
        # each round start.  A straggler delivery from the previous round
        # lands in the current mailbox — one round of gossip staleness,
        # the p2p analogue of the server's late buffer.
        self._inbox: list[dict[int, np.ndarray]] = [
            {} for _ in self.clients]
        self.history: list[RoundResult] = []
        self.on_round_end: Optional[Callable] = None
        # The device the rounds' wire stages and batched training run on
        # (the package default when None), as FederatedSystem.device.
        self.device: Optional[_device.DeviceLike] = None
        self.decode_errors = 0
        self.retx_total = 0
        self._failed_legs = 0
        self._round_idx = -1
        # Optional repro_torch.core.client_compute.BatchTrainer: every client's
        # training input is its round-start model, so the whole round is
        # submitted up front and trains as one vmapped batch at the first
        # timer fire.  None = the per-client train_fn path.
        self.batch_trainer: Optional[Any] = None
        self._rx = [self.transport.create_receiver(
            sim, sim.node(c.addr), cfg.transport, self._make_deliver(i))
            for i, c in enumerate(self.clients)]

    # -- receive side ---------------------------------------------------------
    def _make_deliver(self, i: int):
        def _cb(d) -> None:
            if not d.complete and not self.transport.caps.partial_delivery:
                return
            j = self._addr_idx.get(d.sender_addr)
            if j is None:
                return
            self._inbox[i][j] = self._decode(d.reassemble())
        return _cb

    def _decode(self, data: bytes) -> np.ndarray:
        """ServerCore.decode_vec's contract, peer-side: self-describing
        payloads decode from their header; failures degrade explicitly to
        a zero vector + counter."""
        try:
            if self.pipeline.self_describing:
                vec, negotiated = wire_decode_payload(data)
                if negotiated.caps.delta_domain:
                    raise WireDecodeError(
                        "gossip mixes weight-domain models; a delta-domain "
                        "payload has no reference to apply against")
            else:
                vec = self.pipeline.decode(data)
        except WireDecodeError:
            self.decode_errors += 1
            vec = np.zeros(self._n_params, dtype=np.float32)
        if vec.size < self._n_params:
            vec = np.concatenate(
                [vec, np.zeros(self._n_params - vec.size, np.float32)])
        return vec[:self._n_params]

    # -- send side ------------------------------------------------------------
    def _note_retx(self, sender) -> None:
        self.retx_total += getattr(sender.stats, "retransmissions", 0)

    def _note_fail(self, sender) -> None:
        self._note_retx(sender)
        self._failed_legs += 1

    def _train_and_send(self, i: int) -> None:
        c = self.clients[i]
        if self.batch_trainer is not None:
            _, new_params, metrics = self.batch_trainer.collect(
                (self._round_idx, i))
        else:
            new_params, metrics = c.train_fn(c.params, self._round_idx, c)
        c.metrics_history.append(metrics)
        c.params = new_params
        vec = flatten_to_vector(new_params)
        node = self.sim.node(c.addr)
        for j in sorted(self.adj[i]):
            data = self.pipeline.encode(vec, None)
            packets = packetize(data, c.addr, self._round_idx,
                                self.cfg.transport.mtu)
            self.transport.create_sender(
                self.sim, node, self.sim.node(self.clients[j].addr),
                packets, self.cfg.transport,
                on_complete=self._note_retx, on_fail=self._note_fail,
            ).start()

    # -- the round ------------------------------------------------------------
    def run_round(self, round_idx: Optional[int] = None) -> RoundResult:
        if round_idx is not None:
            raise ValueError("gossip numbers its own rounds (they key the "
                             "wire transactions)")
        with _device.use_device(self.device):
            return self._run_round()

    def _run_round(self) -> RoundResult:
        self._round_idx += 1
        stats0 = dict(self.sim.stats)
        retx0 = self.retx_total
        self._failed_legs = 0
        t0 = self.sim.now_ns
        for box in self._inbox:
            box.clear()
        if self.batch_trainer is not None:
            for i, c in enumerate(self.clients):
                self.batch_trainer.submit((self._round_idx, i), c.addr,
                                          c.params, self._round_idx)
        for i, c in enumerate(self.clients):
            self.sim.schedule(c.train_time_ns,
                              lambda i=i: self._train_and_send(i))
        self.sim.run()

        arrived = []
        mixed_in = 0
        for i, c in enumerate(self.clients):
            own = flatten_to_vector(c.params)
            num = c.weight * own
            den = c.weight
            for j in sorted(self._inbox[i]):
                w = self.clients[j].weight
                num = num + w * self._inbox[i][j]
                den += w
            mixed_in += len(self._inbox[i])
            if self._inbox[i]:
                arrived.append(c.addr)
            c.params = unflatten_from_vector(
                (num / den).astype(np.float32), self._template)

        s1 = self.sim.stats
        result = RoundResult(
            round_idx=self._round_idx,
            duration_ns=self.sim.now_ns - t0,
            arrived=sorted(arrived),
            failed=[],
            skipped_unhealthy=[],
            late_folded=0,
            bytes_sent=s1["bytes_sent"] - stats0["bytes_sent"],
            packets_sent=s1["packets_sent"] - stats0["packets_sent"],
            packets_dropped=(s1["packets_dropped"]
                             - stats0["packets_dropped"]),
            retransmissions=self.retx_total - retx0,
            roster=sorted(c.addr for c in self.clients),
            data_packets=s1.get("sent_data", 0) - stats0.get("sent_data", 0),
            nack_packets=s1.get("sent_nack", 0) - stats0.get("sent_nack", 0),
            parity_packets=(s1.get("sent_parity", 0)
                            - stats0.get("sent_parity", 0)),
            metrics={
                "neighbors_mean": mixed_in / len(self.clients),
                "failed_legs": self._failed_legs,
                "decode_errors": self.decode_errors,
            },
        )
        self.history.append(result)
        if self.on_round_end is not None:
            self.on_round_end(result, self.global_params)
        return result

    def run_rounds(self, n: int) -> list[RoundResult]:
        return [self.run_round() for _ in range(n)]

    @property
    def global_params(self) -> Any:
        num = None
        den = 0.0
        for c in self.clients:
            v = c.weight * flatten_to_vector(c.params)
            num = v if num is None else num + v
            den += c.weight
        return unflatten_from_vector((num / den).astype(np.float32),
                                     self._template)


class GossipTopology(Topology):
    """Serverless: a seeded ~``neighbors``-regular peer graph, one link
    pair per edge (each direction drawn from the *sender's* profile), and
    a :class:`GossipSystem` driving train/exchange/mix rounds."""

    name = "gossip"
    hops = ("peer->peer",)
    uplink_hop = "peer->peer"
    downlink_hop = None

    def build(self, fleet, profiles, global_params, train_fn_factory,
              fl_cfg):
        from repro_torch.core.fleet import _loss_model
        fl_cfg = fl_cfg if fl_cfg is not None else FLConfig()
        if fl_cfg.send_deltas or fl_cfg.error_feedback:
            raise ValueError(
                "gossip cannot ship deltas or run error feedback: peers mix "
                "full models and hold no per-peer encoder state")
        hop = resolved_hop_specs(fleet, self)
        spec = hop.get("peer->peer")
        t = fl_cfg.transport
        pipeline = (parse_pipeline(spec) if spec is not None
                    else legacy_pipeline(t.codec, t.codec_kwargs))
        if pipeline.caps.delta_domain or pipeline.caps.stateful:
            raise ValueError(
                "gossip requires a stateless weight-domain pipeline: peers "
                "mix full models and hold no per-peer encoder state "
                "(delta/ef stages cannot ride this hop)")
        cfg = fl_cfg

        from repro_torch.core.channel import Link
        sim = Simulator(engine=fleet.engine)
        adj = neighbor_graph(fleet.n_clients, fleet.neighbors, fleet.seed)
        seen = set()
        for i in range(fleet.n_clients):
            for j in sorted(adj[i]):
                if (j, i) in seen or (i, j) in seen:
                    continue
                seen.add((i, j))
                pi, pj = profiles[i], profiles[j]
                sij = hash((int(fleet.seed), 0x60551B, i, j)) \
                    & 0x7FFFFFFFFFFF
                link_ij = Link(pi.up_rate_bps, pi.delay_ns,
                               _loss_model(pi, sij),
                               jitter_ns=pi.jitter_ns, jitter_seed=sij + 1)
                link_ji = Link(pj.up_rate_bps, pj.delay_ns,
                               _loss_model(pj, sij + 2),
                               jitter_ns=pj.jitter_ns, jitter_seed=sij + 3)
                sim.connect(pi.addr, pj.addr, link_ij, link_ji)
                sim.label_hop(pi.addr, pj.addr, "peer->peer")
                sim.label_hop(pj.addr, pi.addr, "peer->peer")
        system = GossipSystem(sim, profiles, adj, global_params,
                              train_fn_factory, cfg, pipeline)
        return sim, system


register_topology("star", StarTopology)
register_topology("hier", HierTopology)
register_topology("gossip", GossipTopology)
