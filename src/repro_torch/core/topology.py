"""Topology engine: how a fleet is *wired*, as a pluggable policy.

The paper validates MUDP on a 3-node star and defers "a larger Federated
learning system".  This module makes the wiring a registry-keyed
abstraction — the same idiom as transports
(``repro_torch.core.transport``) and wire stages
(``repro_torch.core.wire``).  The port has one built-in so far:

* ``star`` — the paper's topology, wired exactly as the reference's
  ``star`` (same link draws, same construction order, same FLConfig
  overrides).

The reference's other two wait for a later slice of the port, and
:func:`make_topology` refuses them until then:

* ``hier`` — a two-tier tree: clients are partitioned into *cells*, each
  served by an **edge aggregator** that runs a local FedAvg round over its
  cell through a nested :class:`~repro_torch.core.server.ServerCore` and
  forwards one merged, weight-carrying update upstream.  The root link
  carries O(aggregators) traffic instead of O(clients) — *the*
  architecture for the million-client north star.  The root tier is a
  regular :class:`~repro_torch.core.rounds.FederatedSystem`, so sync
  *and* async scheduling both work above the edges unchanged.
* ``gossip`` — serverless peer-to-peer federation (PeerFL-style): clients
  exchange updates over the existing Transport API on a seeded neighbor
  graph and mix locally; there is no server node anywhere in the
  simulation.

Every *hop* composes independently with the wire plane: a topology
publishes its hop names (``Topology.hops``) and ``FleetConfig.hops``
carries per-hop pipeline specs, e.g. ::

    FleetConfig(hops="client->server: topk(0.01)|int8(1024); "
                     "server->client: int8(1024)")

Per-hop traffic is accounted by :meth:`Simulator.label_hop`
(``sim.hop_bytes``).
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Any, Callable, Optional

from repro_torch.core.rounds import FederatedSystem, FLClient, FLConfig
from repro_torch.core.simulator import Simulator
from repro_torch.core.wire import parse_hop_specs


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


register_topology("star", StarTopology)
