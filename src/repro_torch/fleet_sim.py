"""Fleet-scale scenario on the port: 48 heterogeneous clients, MUDP vs
the UDP baseline, sync vs async scheduling, and star, hier or gossip wiring.

The counterpart of the reference's ``examples/fleet_sim.py``: a seeded
cohort draw (fiber / lte / congested-edge), full participation, a
4-simulated-second deadline (sync: straggler cutoff, late updates folded
into the next round; async: the per-session watchdog) and weighted FedAvg
over whatever arrived.  ``--mode both`` (the default) runs each
scheduling policy on the same 48 clients and prints the simulated
time-to-target-loss of each: the round barrier waits out its slowest
client (or the deadline) every round, the async server aggregates
whenever ``buffer_k`` (8) updates are buffered while clients re-enter at
their own cadence (3 sync rounds against 12 async aggregations).

``--topology`` swaps the wiring (:mod:`repro_torch.core.topology`):
``star`` is the paper's single server, ``hier`` inserts ``--cells`` edge
aggregators that run local FedAvg and forward one merged update
upstream, ``gossip`` drops the server entirely and lets peers exchange
updates at degree ``--neighbors`` (sync only: there is no server to
schedule async rounds).  Each run prints the bytes on each hop.

``--model`` picks what the clients train: ``consensus`` (the analytic
objective of :class:`~repro_torch.core.fleet.ConsensusObjective`) or
``mlp`` (the paper's 784-32-10 MNIST MLP on non-IID dirichlet shards,
trained on the device; prints test accuracy per round).
``--train-backend vmap`` (or ``shard``, the same on one card) trains each
round's whole roster in one ``torch.func.vmap`` call on the device and
prints how many batched calls that took.

``--dist-backend gloo|nccl`` runs the process as one rank of a group that
``torchrun`` started (``nccl`` a card a rank; ``gloo`` any layout, ranks
sharing a card or on the CPU): every rank runs the same deterministic
orchestrator, ``--train-backend shard`` spreads each batch over the
ranks, only rank 0 prints, and each arm ends by checking that the final
global parameters are bitwise equal on every rank.

``--control static`` runs the ``mudp`` and ``udp`` arms with raw weights
on the wire.  ``--control adaptive`` runs ``mudp+fec`` with a
``delta|ef|topk(0.15)|int8(1024)`` uplink and an ``int8(1024)`` downlink
(under hier, the same two specs on every hop, per hop: each cell's core
and the root run their own controller), and each server walks its
clients along the loss-driven ladder of
:class:`~repro_torch.core.control.AdaptivePolicy` (``topk`` 0.4 / 0.15 /
0.04 with FEC parity 0 / 1 / 2); each round then also prints how many
clients sit on each tier.  On this path every client's uplink encode runs
the top-k gather and quantize kernels, and each server's batch decode the
dequantize and top-k scatter kernels, before the fedavg kernel folds the
arrived rows.  Gossip has no server core, so control stays static there.

Runs go to ``cuda`` unless ``--device`` names another device; without a
card, ``cuda`` raises.

    PYTHONPATH=src python -m repro_torch.fleet_sim --device cpu
    PYTHONPATH=src python -m repro_torch.fleet_sim --device cpu --mode async
    PYTHONPATH=src python -m repro_torch.fleet_sim --device cpu \\
        --topology hier --cells 6
    PYTHONPATH=src python -m repro_torch.fleet_sim --device cpu \\
        --model mlp --train-backend vmap --mode sync
    PYTHONPATH=src python -m repro_torch.fleet_sim --device cpu \\
        --model mlp --control adaptive --mode sync
    PYTHONPATH=src python -m torch.distributed.run --standalone \\
        --nproc-per-node 2 -m repro_torch.fleet_sim --device cpu \\
        --model mlp --train-backend shard --dist-backend gloo --mode sync
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import time
from typing import Optional

import torch

from repro_torch import device as _device
from repro_torch.core.fleet import (FleetBuild, FleetConfig,
                                    build_fleet_training, cohort_counts)
from repro_torch.core.packetizer import flatten_to_vector
from repro_torch.core.rounds import FLConfig
from repro_torch.core.transport import TransportConfig
from repro_torch.distributed import ranks

N_CLIENTS = 48
SEED = 7
ROUNDS = 3                          # the reference's sync horizon
ASYNC_ROUNDS = 12                   # ... and its async one (aggregations)
BUFFER_K = 8
CELLS = 4
NEIGHBORS = 4
TARGET_FRAC = 0.1                   # time-to-target = loss <= 10% of L0
NS = 1_000_000_000
UPLINK = "delta|ef|topk(0.15)|int8(1024)"
DOWNLINK = "int8(1024)"

#: The 48-client, 10-round ``--model mlp --control adaptive`` run, round by
#: round: uplinks aggregated, late updates folded, retransmissions, and
#: clients on tiers 0 / 1 / 2 during the round.  Packet sizes depend only
#: on the parameter count, the top-k count and the int8 block, and the
#: link draws are keyed, so none of these depends on the device or on
#: float rounding; the values are the reference's run of the same
#: configuration (``tests/test_torch_fleet.py`` recomputes them from it).
PINNED_ADAPTIVE: tuple[dict, ...] = (
    {"arrived": 43, "late_folded": 0, "retransmissions": 111,
     "tiers": [0, 48, 0]},
    {"arrived": 38, "late_folded": 5, "retransmissions": 60,
     "tiers": [26, 1, 21]},
    {"arrived": 41, "late_folded": 10, "retransmissions": 63,
     "tiers": [22, 5, 21]},
    {"arrived": 41, "late_folded": 7, "retransmissions": 40,
     "tiers": [19, 4, 25]},
    {"arrived": 43, "late_folded": 7, "retransmissions": 58,
     "tiers": [18, 9, 21]},
    {"arrived": 43, "late_folded": 5, "retransmissions": 53,
     "tiers": [18, 7, 23]},
    {"arrived": 42, "late_folded": 5, "retransmissions": 79,
     "tiers": [17, 6, 25]},
    {"arrived": 43, "late_folded": 6, "retransmissions": 39,
     "tiers": [19, 3, 26]},
    {"arrived": 44, "late_folded": 5, "retransmissions": 19,
     "tiers": [18, 2, 28]},
    {"arrived": 43, "late_folded": 4, "retransmissions": 85,
     "tiers": [18, 5, 25]},
)

#: The reference example's consensus arms (``CONSENSUS_ARMS`` over mudp
#: and udp, static control, 48 clients, its horizons), from the
#: reference's live run on the CPU: the SHA-256 of the final global
#: parameters (float32 bytes in tree order), and per round (sync) or
#: aggregation (async) the uplinks aggregated, late updates folded,
#: retransmissions and the bytes each hop carried (in ``hops`` order).
#: The consensus path is numpy on the host plus the fedavg kernel, which
#: is bit-identical to the numpy fold, so the port reproduces every byte
#: on the card too.  ``tests/test_torch_topology.py`` recomputes them
#: from the reference.
PINNED_ARMS: dict = {
    ("hier", "sync", "mudp"): {
        "sha256": "f1aa6dbb54fdc66c3cc8c007e59ed4cf99f7b3c47671cc0a"
                  "9de09a21bef6c53a",
        "hops": ("client->edge", "edge->client", "edge->root", "root->edge"),
        "rounds": (
            (4, 0, 5, (255964, 261913, 20216, 21688)),
            (4, 0, 5, (260885, 261033, 21651, 20216)),
            (4, 0, 5, (266884, 265314, 20290, 21651)),
        )},
    ("hier", "sync", "udp"): {
        "sha256": "a91dc378972ea7b8f176c673f2a9c35da7eb2ad94b569d54"
                  "3f2c39b6a6385b18",
        "hops": ("client->edge", "edge->client", "edge->root", "root->edge"),
        "rounds": (
            (4, 0, 0, (201936, 201936, 16828, 16828)),
            (4, 0, 0, (201936, 201936, 16828, 16828)),
            (4, 0, 0, (201936, 201936, 16828, 16828)),
        )},
    ("hier", "async", "mudp"): {
        "sha256": "0460a51823d9cf6c67d48daff1c73062906c528aea152db2"
                  "215ef6f89472e54f",
        "hops": ("client->edge", "edge->client", "edge->root", "root->edge"),
        "rounds": (
            (4, 0, 3, (252756, 376240, 20290, 31254)),
            (4, 3, 4, (289145, 258644, 18633, 21651)),
            (4, 3, 2, (264347, 271202, 17124, 20105)),
            (4, 3, 4, (266632, 304778, 21762, 18707)),
            (4, 3, 6, (267446, 269730, 23160, 20327)),
            (4, 3, 6, (273297, 259672, 18818, 24632)),
            (4, 3, 3, (253253, 252343, 18707, 21614)),
            (4, 3, 9, (264661, 260356, 20401, 26252)),
            (4, 3, 5, (264563, 264735, 20290, 21614)),
            (4, 3, 7, (263139, 253131, 23197, 21799)),
            (4, 3, 6, (267901, 257412, 20401, 23197)),
            (3, 3, 7, (259840, 268067, 23234, 21836)),
        )},
    ("hier", "async", "udp"): {
        "sha256": "f7e4b79dec8eac9117610338ca9c4db6f719dec61382a15c"
                  "4bde864e7f354217",
        "hops": ("client->edge", "edge->client", "edge->root", "root->edge"),
        "rounds": (
            (4, 0, 0, (227178, 353388, 16828, 29449)),
            (4, 3, 0, (206143, 201936, 16828, 16828)),
            (4, 3, 0, (210350, 201936, 16828, 16828)),
            (4, 3, 0, (210350, 201936, 16828, 16828)),
            (4, 3, 0, (197729, 201936, 16828, 16828)),
            (3, 3, 0, (214557, 201936, 16828, 16828)),
            (4, 3, 0, (189315, 201936, 16828, 16828)),
            (4, 3, 0, (214557, 201936, 16828, 16828)),
            (4, 3, 0, (222971, 201936, 16828, 16828)),
            (4, 3, 0, (210350, 201936, 16828, 16828)),
            (4, 3, 0, (193522, 201936, 16828, 16828)),
            (4, 3, 0, (201936, 201936, 16828, 16828)),
        )},
    ("gossip", "sync", "mudp"): {
        "sha256": "874f8e3e510925e2a8d1682b1db22ebc20d5dd097b58ec52"
                  "8753ee02d55e863a",
        "hops": ("peer->peer",),
        "rounds": (
            (48, 0, 188, (1272346,)),
            (48, 0, 169, (1240497,)),
            (48, 0, 174, (1250234,)),
        )},
    ("gossip", "sync", "udp"): {
        "sha256": "08b02025cca9adbb6f0761040833f06cac531fa7677ece5a"
                  "b4e983709f50adb9",
        "hops": ("peer->peer",),
        "rounds": (
            (48, 0, 0, (967610,)),
            (48, 0, 0, (967610,)),
            (48, 0, 0, (967610,)),
        )},
    ("star", "async", "mudp"): {
        "sha256": "bf656c4d0f1d92405fd989e429bb07b178cbd53dff6a14c6"
                  "23e2257c0ea320f6",
        "hops": ("client->server", "server->client"),
        "rounds": (
            (8, 0, 45, (52084, 272972)),
            (8, 8, 17, (45292, 52504)),
            (8, 8, 8, (41399, 27626)),
            (8, 8, 7, (41534, 20586)),
            (8, 8, 10, (37451, 39021)),
            (8, 8, 11, (39071, 50564)),
            (8, 8, 12, (43635, 43487)),
            (8, 8, 13, (45033, 51975)),
            (8, 8, 7, (40062, 17851)),
            (8, 8, 13, (60339, 32166)),
            (8, 8, 14, (28070, 43376)),
            (8, 8, 5, (48587, 25945)),
        )},
    ("star", "async", "udp"): {
        "sha256": "4511a8b854b54ea696267428bfdc37c1f816ee104cb63025"
                  "c2d61f156840d6f4",
        "hops": ("client->server", "server->client"),
        "rounds": (
            (8, 0, 0, (33656, 214557)),
            (8, 8, 0, (33656, 33656)),
            (8, 8, 0, (37863, 21035)),
            (8, 8, 0, (33656, 16828)),
            (8, 8, 0, (33656, 29449)),
            (8, 8, 0, (33656, 37863)),
            (8, 8, 0, (33656, 33656)),
            (8, 8, 0, (33656, 42070)),
            (8, 8, 0, (33656, 12621)),
            (8, 8, 0, (42070, 16828)),
            (8, 8, 0, (25242, 33656)),
            (8, 8, 0, (42070, 25242)),
        )},
}

PINNED_HIER_ADAPTIVE: dict = {
    "hops": ("client->edge", "edge->client", "edge->root", "root->edge"),
    "rounds": (
        (4, 0, 1, (1194265, 1580294, 93938, 124421),
         {"root": [0, 4, 0],
          "cells": [[0, 12, 0], [0, 12, 0], [0, 12, 0], [0, 12, 0]]}),
        (4, 0, 2, (1595620, 1628708, 180495, 113385),
         {"root": [3, 1, 0],
          "cells": [[6, 0, 6], [5, 0, 7], [7, 0, 5], [8, 1, 3]]}),
        (4, 0, 0, (1484073, 1654847, 180347, 110441),
         {"root": [3, 1, 0],
          "cells": [[6, 0, 6], [4, 1, 7], [5, 2, 5], [7, 2, 3]]}),
    )}

#: ``PINNED_HIER_ADAPTIVE`` is the MLP's adaptive arm under hier (the
#: per-hop specs of ``configs``, ``mudp+fec``, 3 sync rounds), from the
#: same run, with each round's tier counts of the root (the edges) and of
#: each cell; like ``PINNED_ADAPTIVE``, none of it depends on float
#: rounding, so it holds for the port's MLP on any device.

#: The arms of the reference's example that train the consensus
#: objective at its default width (1024 parameters) with static control,
#: as (topology, mode): each runs over ``mudp`` and ``udp``.
CONSENSUS_ARMS = (("hier", "sync"), ("hier", "async"), ("gossip", "sync"),
                  ("star", "async"))


def rounds_for(mode: str) -> int:
    """The reference example's horizon: 3 sync rounds or 12 async
    aggregations (about the same simulated time)."""
    return ROUNDS if mode == "sync" else ASYNC_ROUNDS


def configs(transport: str = "mudp+fec", *, n_clients: int = N_CLIENTS,
            model: str = "mlp", control: str = "adaptive",
            model_args: Optional[dict] = None, mode: str = "sync",
            topology: str = "star", cells: int = CELLS,
            neighbors: int = NEIGHBORS, train_backend: str = "python"
            ) -> tuple[FleetConfig, FLConfig]:
    """The fleet and FL configurations of one arm, as the reference's
    ``examples/fleet_sim.py`` ``run()`` builds them: adaptive control puts
    the two wire specs on the star's uplink and downlink, or on every hop
    of a hier tree; gossip has no server core, so it stays static."""
    adaptive = control == "adaptive" and topology != "gossip"
    hops, wire = None, {}
    if adaptive:
        if topology == "hier":
            hops = (f"client->edge: {UPLINK}; edge->client: {DOWNLINK}; "
                    f"edge->root: {UPLINK}; root->edge: {DOWNLINK}")
        else:
            wire = {"uplink": UPLINK, "downlink": DOWNLINK}
    fleet = FleetConfig(n_clients=n_clients, seed=SEED, mode=mode,
                        buffer_k=BUFFER_K, round_deadline_ns=4 * NS,
                        topology=topology, cells=cells, neighbors=neighbors,
                        model=model, model_args=model_args,
                        train_backend=train_backend, hops=hops,
                        control="adaptive" if adaptive else "static")
    cfg = FLConfig(aggregation="fedavg",
                   transport=TransportConfig(kind=transport,
                                             timeout_ns=2 * NS,
                                             udp_deadline_ns=3 * NS,
                                             **wire))
    return fleet, cfg


def server_cores(system) -> list:
    """Every ServerCore of a built system: one under star, the root and
    each cell under hier, none under gossip."""
    if hasattr(system, "edges"):
        return [system.root.core] + [e.core for e in system.edges]
    return [system.core] if hasattr(system, "core") else []


def _tiers_of(core, addrs) -> Optional[list[int]]:
    policy = core.controller
    if policy is None or not hasattr(policy, "tier_of"):
        return None
    counts = [0] * len(policy.tiers)
    for addr in addrs:
        counts[policy.tier_of(addr)] += 1
    return counts


def tier_counts(build: FleetBuild):
    """Clients on each rung of the adaptive ladder (None without one):
    one list under star; under hier ``{"root": edges on each rung,
    "cells": [each cell's clients on each rung]}``."""
    system = build.system
    if hasattr(system, "edges"):
        root = _tiers_of(system.root.core, [e.addr for e in system.edges])
        if root is None:
            return None
        return {"root": root,
                "cells": [_tiers_of(e.core, sorted(e.core.pool.clients))
                          for e in system.edges]}
    if not hasattr(system, "core"):
        return None
    return _tiers_of(system.core, [p.addr for p in build.profiles])


def params_sha256(params) -> str:
    """SHA-256 of a parameter tree's float32 bytes, in tree order."""
    return hashlib.sha256(flatten_to_vector(params).tobytes()).hexdigest()


def build(transport: str = "mudp+fec", *, n_clients: int = N_CLIENTS,
          model: str = "mlp", control: str = "adaptive",
          model_args: Optional[dict] = None, mode: str = "sync",
          topology: str = "star", cells: int = CELLS,
          neighbors: int = NEIGHBORS, train_backend: str = "python",
          device: _device.DeviceLike | None = None) -> FleetBuild:
    """One arm, wired and not yet run, on ``device`` (the package
    default, ``cuda``, when None): the model's data and training and the
    rounds' wire and aggregation kernels all run there."""
    dev = _device.resolve(device)
    with _device.use_device(dev):
        fleet, cfg = configs(transport, n_clients=n_clients, model=model,
                             control=control, model_args=model_args,
                             mode=mode, topology=topology, cells=cells,
                             neighbors=neighbors,
                             train_backend=train_backend)
        fleet_build = build_fleet_training(fleet, cfg)
    fleet_build.system.device = dev
    return fleet_build


def run_rounds(fleet_build: FleetBuild, rounds: int) -> list[dict]:
    """Run ``rounds`` rounds (sync) or aggregations (async) of a built
    arm in one ``run_rounds`` call, as the reference's example does.
    Returns one record per round, the first (``round`` 0) being the model
    before them; ``wall_s`` is the host wall time from the end of the
    previous round's record to the end of this round, once the device is
    idle (evaluation excluded), and ``hop_bytes`` the bytes each hop
    carried in the round."""
    system, objective, sim = (fleet_build.system, fleet_build.model,
                              fleet_build.sim)

    def evaluate(params) -> dict:
        rec = {"loss": objective.loss(params)}
        if hasattr(objective, "accuracy"):
            rec["accuracy"] = objective.accuracy(params)
        return rec

    def idle() -> None:
        dev = getattr(system, "device", None)
        if dev is not None and torch.device(dev).type == "cuda":
            torch.cuda.synchronize(dev)

    records = [{"round": 0, "sim_ns": sim.now_ns,
                "cohorts": cohort_counts(fleet_build.profiles),
                **evaluate(system.global_params)}]
    hops0 = dict(sim.hop_bytes)
    clock = [time.perf_counter()]

    def on_round(res, params) -> None:
        idle()
        wall = time.perf_counter() - clock[0]
        hops = {hop: b - hops0.get(hop, 0)
                for hop, b in sorted(sim.hop_bytes.items())}
        hops0.update(sim.hop_bytes)
        records.append({
            "round": len(records), "arrived": len(res.arrived),
            "failed": len(res.failed),
            "cut": len(set(res.roster) - set(res.arrived) - set(res.failed)),
            "late_folded": res.late_folded,
            "retransmissions": res.retransmissions,
            "packets_sent": res.packets_sent, "bytes_sent": res.bytes_sent,
            "hop_bytes": hops, "decode_errors": res.decode_errors,
            "tiers": tier_counts(fleet_build),
            "renegotiations": sum(sum(c.renegotiations.values())
                                  for c in server_cores(system)),
            "sim_ns": sim.now_ns, "wall_s": wall, **evaluate(params)})
        clock[0] = time.perf_counter()

    system.on_round_end = on_round
    try:
        system.run_rounds(rounds)
    finally:
        system.on_round_end = None
    return records


def pinned_view(records: list[dict]) -> dict:
    """The per-round fields the pins hold, in their form: the hop names
    once, then per round (uplinks aggregated, late updates folded,
    retransmissions, the bytes of each hop) and, where the arm has a
    control ladder, its tier counts.  None of them depends on float
    rounding (packet sizes depend only on the parameter count, the top-k
    count and the int8 block; the link draws are keyed)."""
    hops = tuple(records[1]["hop_bytes"])
    rounds = []
    for rec in records[1:]:
        row = (rec["arrived"], rec["late_folded"], rec["retransmissions"],
               tuple(rec["hop_bytes"].get(h, 0) for h in hops))
        if rec["tiers"] is not None:
            row += (rec["tiers"],)
        rounds.append(row)
    return {"hops": hops, "rounds": tuple(rounds)}


def run(transport: str = "mudp+fec", *, rounds: Optional[int] = None,
        **build_kwargs) -> list[dict]:
    """:func:`build` one arm and :func:`run_rounds` it (``rounds``
    defaults to the reference's horizon for the arm's mode)."""
    fleet_build = build(transport, **build_kwargs)
    if rounds is None:
        rounds = rounds_for(build_kwargs.get("mode", "sync"))
    return run_rounds(fleet_build, rounds)


def profile(trace_path: str, rounds: int = 3, **build_kwargs) -> dict:
    """Trace ``rounds`` rounds (after one untraced warm-up round) of one
    arm with ``torch.profiler`` on a CUDA device and write the chrome
    trace to ``trace_path``.  Returns the host wall time of the traced
    rounds, the device busy time, the idle share and device time by
    kernel (:func:`repro_torch.fl_mnist.trace_summary`)."""
    from torch.profiler import ProfilerActivity

    from repro_torch.fl_mnist import trace_summary
    system = build(**build_kwargs).system
    if torch.device(system.device).type != "cuda":
        raise RuntimeError("profile() measures a CUDA device")
    system.run_rounds(1)
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        system.run_rounds(rounds)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(trace_path)
    return {"rounds": rounds, "wall_s": wall,
            **trace_summary(trace_path, wall)}


def _shape(topology: str, cells: int, neighbors: int) -> str:
    return {"star": "star", "hier": f"hier x{cells} cells",
            "gossip": f"gossip k={neighbors}"}[topology]


def _print_arm(fleet_build: FleetBuild, records: list[dict], *,
               transport: str, mode: str, topology: str, cells: int,
               neighbors: int, model: str, train_backend: str) -> None:
    head = records[0]
    print(f"\n=== {transport} / {mode} / "
          f"{_shape(topology, cells, neighbors)} / {model}[{train_backend}]: "
          f"{sum(head['cohorts'].values())} clients, cohorts "
          f"{head['cohorts']} ===")
    target = TARGET_FRAC * head["loss"]
    crossed = None
    for rec in records[1:]:
        if crossed is None and rec["loss"] <= target:
            crossed = rec["sim_ns"]
        acc = f" | acc {rec['accuracy']:.3f}" if "accuracy" in rec else ""
        tiers = f" | tiers {rec['tiers']}" if rec["tiers"] else ""
        print(f"round {rec['round'] - 1}: arrived {rec['arrived']:2d} | "
              f"in-flight/cut {rec['cut']:2d} | late-folded "
              f"{rec['late_folded']} | retx {rec['retransmissions']:3d} | "
              f"{rec['bytes_sent'] / 1e6:.2f} MB on wire | loss "
              f"{rec['loss']:.4f}{acc}{tiers} | wall {rec['wall_s']:.3f} s")
    hops = " | ".join(f"{hop} {b / 1e6:.2f} MB" for hop, b in
                      sorted(fleet_build.sim.hop_bytes.items()))
    if fleet_build.trainer is not None:
        sizes = fleet_build.trainer.batch_sizes
        print(f"    [{train_backend}] {sum(sizes)} client-trainings in "
              f"{len(sizes)} batched calls (sizes {sizes})")
    if crossed is not None:
        print(f"--> {mode} time-to-target-loss ({TARGET_FRAC:.0%} of L0): "
              f"{crossed / 1e9:.2f} simulated seconds  [{hops}]")
    else:
        print(f"--> {mode}: target loss not reached in {len(records) - 1} "
              f"rounds  [{hops}]")
    cores = server_cores(fleet_build.system)
    if any(c.controller is not None for c in cores):
        cohort_of = {p.addr: p.cohort for p in fleet_build.profiles}
        by_cohort: dict = {}
        for core in cores:
            for addr, n in core.renegotiations.items():
                key = cohort_of.get(addr, "edge")
                by_cohort[key] = by_cohort.get(key, 0) + n
        print(f"    [adaptive] renegotiations by cohort: "
              f"{dict(sorted(by_cohort.items()))} "
              f"({records[-1]['renegotiations']} total)")


def _same_on_every_rank(params) -> str:
    """The parameters' sha256, raising unless every rank of the group
    holds the same bytes."""
    import torch.distributed as dist
    sha = params_sha256(params)
    shas = [None] * ranks.world_size()
    dist.all_gather_object(shas, sha)
    if len(set(shas)) != 1:
        raise RuntimeError(f"final global parameters differ across the "
                           f"ranks: sha256 by rank {shas}")
    return sha


def _arm_record(fleet_build: FleetBuild) -> dict:
    """What ``--out`` keeps of an arm: per round the roster, the arrivals
    and ``duration_ns``, the batch sizes, and the final global
    parameters (float32 bytes, hex)."""
    system = fleet_build.system
    return {"history": [{"roster": list(r.roster),
                         "arrived": list(r.arrived),
                         "duration_ns": r.duration_ns}
                        for r in system.history],
            "batch_sizes": (list(fleet_build.trainer.batch_sizes)
                            if fleet_build.trainer is not None else None),
            "params_f32": flatten_to_vector(system.global_params).tobytes()
            .hex()}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", default="both",
                    choices=["sync", "async", "both"],
                    help="scheduling policy (default: both, printing "
                         "time-to-target-loss for each)")
    ap.add_argument("--topology", default="star",
                    choices=["star", "hier", "gossip"],
                    help="fleet wiring: the paper's star, hierarchical "
                         "edge aggregation, or serverless gossip")
    ap.add_argument("--cells", type=int, default=CELLS,
                    help="hier only: number of edge aggregators")
    ap.add_argument("--neighbors", type=int, default=NEIGHBORS,
                    help="gossip only: target peer degree")
    ap.add_argument("--model", default="consensus",
                    choices=["consensus", "mlp"],
                    help="what the clients train: the analytic consensus "
                         "objective or the MNIST MLP on non-IID shards")
    ap.add_argument("--train-backend", default="python",
                    choices=["python", "vmap", "shard"],
                    help="how local training executes: per-client loop, "
                         "or one torch.func.vmap call per round on the "
                         "device (shard: the same on one card, spread over "
                         "the ranks with --dist-backend)")
    ap.add_argument("--control", default="static",
                    choices=["static", "adaptive"],
                    help="static runs mudp and udp; adaptive runs mudp+fec "
                         "and walks each client along the loss-driven "
                         "compression/FEC ladder")
    ap.add_argument("--transport", default=None,
                    choices=["mudp", "udp", "mudp+fec"],
                    help="run this transport's arm alone (default: the "
                         "control's arms)")
    ap.add_argument("--clients", type=int, default=N_CLIENTS)
    ap.add_argument("--rounds", type=int, default=None,
                    help="rounds (sync) or aggregations (async); default "
                         f"{ROUNDS} / {ASYNC_ROUNDS}")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--dist-backend", default=None, choices=ranks.BACKENDS,
                    help="run as one rank of the group torchrun started, "
                         "with this backend (nccl: a card a rank)")
    ap.add_argument("--out", metavar="JSON", default=None,
                    help="write each arm's rosters, arrivals, duration_ns, "
                         "batch sizes and final global parameters here "
                         "(rank 0)")
    ap.add_argument("--profile", metavar="TRACE_JSON", default=None,
                    help="trace the rounds of the first arm on the card "
                         "with torch.profiler, write the chrome trace here "
                         "and print the device busy time and idle share")
    args = ap.parse_args(argv)
    modes = ["sync", "async"] if args.mode == "both" else [args.mode]
    if args.topology == "gossip":
        modes = ["sync"]   # gossip has no server to schedule async rounds
    transports = (("mudp+fec",) if args.control == "adaptive"
                  else ("mudp", "udp"))
    if args.transport is not None:
        transports = (args.transport,)
    kw = dict(n_clients=args.clients, model=args.model,
              control=args.control, topology=args.topology,
              cells=args.cells, neighbors=args.neighbors,
              train_backend=args.train_backend, device=args.device)
    if args.profile:
        rounds = args.rounds or rounds_for(modes[0])
        print(json.dumps(profile(args.profile, rounds,
                                 transport=transports[0], mode=modes[0],
                                 **kw)))
        return
    group = (ranks.group(args.dist_backend, device_type=torch.device(
        args.device or _device.default_device()).type)
        if args.dist_backend else contextlib.nullcontext())
    with group:
        lead = ranks.rank() == 0
        arms = []
        for transport in transports:
            for mode in modes:
                with (contextlib.nullcontext() if lead else
                      contextlib.redirect_stdout(io.StringIO())):
                    fleet_build = build(transport, mode=mode, **kw)
                    records = run_rounds(fleet_build,
                                         args.rounds or rounds_for(mode))
                    _print_arm(fleet_build, records, transport=transport,
                               mode=mode, topology=args.topology,
                               cells=args.cells, neighbors=args.neighbors,
                               model=args.model,
                               train_backend=args.train_backend)
                if args.dist_backend:
                    sha = _same_on_every_rank(fleet_build.system
                                              .global_params)
                    if lead:
                        print(f"    [{args.dist_backend}] final global "
                              f"parameters bitwise equal on "
                              f"{ranks.world_size()} ranks (sha256 {sha})")
                arms.append(dict(_arm_record(fleet_build),
                                 transport=transport, mode=mode))
        if args.out and lead:
            with open(args.out, "w") as f:
                json.dump({"ranks": ranks.world_size(), "arms": arms}, f)


if __name__ == "__main__":
    main()
