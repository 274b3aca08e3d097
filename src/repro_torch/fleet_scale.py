"""Fleet-scale FL on the port: heterogeneous cohorts, partial
participation, straggler-aware rounds, for every registered transport.

The counterpart of the reference's ``benchmarks/fleet_scale.py``, with the
same options and the same report.  For each fleet size and each transport
in ``available_transports()`` the same seeded :class:`FleetConfig`
(identical cohorts, link draws, and per-round client samples — the
transport is the only variable) runs ``--rounds`` FL rounds of the
synthetic consensus objective and reports: simulated round time,
rounds/sec (simulated and wall), bytes on wire (total and per hop),
retransmissions, arrivals vs roster (stragglers cut at the deadline), and
rounds-to-target-loss.  ``--topology hier|gossip`` swaps the wiring (edge
aggregation / serverless peer exchange — :mod:`repro_torch.core.topology`);
a ``scaling`` section summarizes clients-vs-wall-time across the
``--clients`` sweep.  Results land in ``--out`` (default
``BENCH_fleet_torch.json``, beside the reference's ``BENCH_fleet.json``).

What the simulation decides is bit-for-bit reproducible for a fixed seed,
and equal to what the reference's script writes for the same arguments:
everything but the top-level ``"wall"`` key and the wall-clock fields of
``"scaling"`` and ``"flow_gate"`` (:func:`reproducible` drops them;
``--replay-check`` proves it by running the whole matrix twice).  The
event calendar, transports and keyed draws are host Python and numpy; the
server's (and under ``hier`` each edge cell's) FedAvg folds the arrived
updates on the device through the fedavg kernel
(:func:`repro_torch.core.aggregation.weighted_sum_stack`), whose bits are
the numpy fold's.

``--engine flow`` swaps in the analytic flow engine
(:mod:`repro_torch.core.flow`): same seeded scenario, per-burst closed
forms instead of per-packet events — the only engine that takes
10k/100k-client fleets in minutes.  ``--flow-gate`` additionally runs one
mudp cell on both the batched and flow engines and fails unless flow
clears ``--flow-gate-min`` x the packet events per wall second.

``--device`` names the device of the array work (default ``cuda``, which
raises without a card); ``--profile TRACE_JSON`` traces one round of the
first fleet size and transport on the card after one untraced round,
writes the chrome trace and prints the device busy time and idle share.

The process exits non-zero if any requested transport is missing from the
results, so no transport is ever silently skipped.

  PYTHONPATH=src python -m repro_torch.fleet_scale --device cpu \\
      --clients 100 --rounds 2
  PYTHONPATH=src python -m repro_torch.fleet_scale --device cpu \\
      --clients 64 --rounds 1 --replay-check
  PYTHONPATH=src python -m repro_torch.fleet_scale --clients 10000,100000 \\
      --engine flow --topology hier --cells 32 --transports mudp \\
      --flow-gate
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time

from repro_torch import device as _device
from repro_torch.core.fleet import (ConsensusObjective, FleetConfig,
                                    build_fleet, cohort_counts,
                                    profiles_digest)
from repro_torch.core.rounds import FLConfig
from repro_torch.core.transport import TransportConfig, available_transports

NS_PER_SEC = 1_000_000_000


def build_cell(transport: str, *, n_clients: int, seed: int,
               participation: float, deadline_ns: int, n_params: int,
               engine: str = "batched", mode: str = "sync",
               buffer_k: int = 8, topology: str = "star", cells: int = 4,
               neighbors: int = 4) -> tuple:
    """The seeded fleet of one (transport, fleet size) cell, built:
    ``(sim, system, profiles, objective)``."""
    fleet = FleetConfig(n_clients=n_clients, seed=seed,
                        participation_fraction=participation,
                        round_deadline_ns=deadline_ns, engine=engine,
                        mode=mode, buffer_k=buffer_k, topology=topology,
                        cells=min(cells, n_clients),
                        neighbors=min(neighbors, n_clients - 1))
    objective = ConsensusObjective(n_clients, n_params, seed=seed)
    fl_cfg = FLConfig(
        aggregation="fedavg",
        transport=TransportConfig(kind=transport,
                                  timeout_ns=2 * NS_PER_SEC,
                                  udp_deadline_ns=3 * NS_PER_SEC))
    sim, system, profiles = build_fleet(fleet, objective.init_params(),
                                        objective.train_fn, fl_cfg)
    return sim, system, profiles, objective


def run_fleet(transport: str, *, rounds: int, **cell) -> dict:
    """One (transport, fleet size) cell (:func:`build_cell`'s arguments)
    run for ``rounds`` rounds. Returns a JSON-ready dict whose every field
    derives from the simulation — no wall-clock anywhere.
    ``mode="async"`` runs FedBuff-style scheduling: each row is one
    buffered aggregation instead of one barrier round.  ``topology``
    picks the wiring (repro_torch.core.topology): ``star``, ``hier`` (with
    ``cells`` edge aggregators), or ``gossip`` (degree ``neighbors``)."""
    sim, system, profiles, objective = build_cell(transport, **cell)
    loss0 = objective.loss(system.global_params)
    round_rows, losses = [], []

    # Loss must be sampled per aggregation event: under async scheduling
    # rounds complete *inside* one run_rounds() call, so a post-hoc loop
    # would only ever see the final model.
    def _on_round(r, params):
        loss = objective.loss(params)
        losses.append(loss)
        round_rows.append({
            "round": r.round_idx,
            "duration_ns": r.duration_ns,
            "roster": len(r.roster),
            "arrived": len(r.arrived),
            "failed": len(r.failed),
            "late_folded": r.late_folded,
            "bytes_sent": r.bytes_sent,
            "packets_sent": r.packets_sent,
            "packets_dropped": r.packets_dropped,
            "retransmissions": r.retransmissions,
            "data_packets": r.data_packets,
            "nack_packets": r.nack_packets,
            "parity_packets": r.parity_packets,
            "decode_errors": r.decode_errors,
            "bcast_cache_hits": r.bcast_cache_hits,
            "staleness_clamped": r.staleness_clamped,
            "metrics": r.metrics,
            "loss": loss,
        })

    system.on_round_end = _on_round
    system.run_rounds(rounds)
    sim_ns = sum(r["duration_ns"] for r in round_rows)
    # len(round_rows), not the requested count: an async run may drain
    # early with fewer aggregations than asked for.
    return {
        "cohorts": cohort_counts(profiles),
        "hop_bytes": dict(sorted(sim.hop_bytes.items())),
        "profiles_digest": profiles_digest(profiles),
        "rounds": round_rows,
        "sim_time_ns": sim_ns,
        "rounds_per_sim_sec": (len(round_rows) * NS_PER_SEC / sim_ns)
        if sim_ns else None,
        "bytes_on_wire": sum(r["bytes_sent"] for r in round_rows),
        "retransmissions": sum(r["retransmissions"] for r in round_rows),
        "initial_loss": loss0,
        "final_loss": losses[-1] if losses else loss0,
        "rounds_to_target_loss": next(
            (i + 1 for i, v in enumerate(losses) if v <= 0.1 * loss0), None),
    }


def bench(rounds: int = 1):
    """``(row name, wall us, derived fields)``, as the reference's
    ``bench()``: a small fleet across all transports."""
    rows = []
    for tr in available_transports():
        t0 = time.perf_counter()
        cell = run_fleet(tr, rounds=rounds, n_clients=16, seed=0,
                         participation=0.75, deadline_ns=20 * NS_PER_SEC,
                         n_params=1024)
        wall_us = (time.perf_counter() - t0) * 1e6
        rows.append((f"fleet_scale/{tr}_c16", wall_us,
                     f"sim_s={cell['sim_time_ns'] / 1e9:.2f}"
                     f";bytes={cell['bytes_on_wire']}"
                     f";retx={cell['retransmissions']}"
                     f";loss={cell['final_loss']:.4f}"))
    return rows


def _cell_kwargs(args) -> dict:
    return dict(rounds=args.rounds, seed=args.seed,
                participation=args.participation,
                deadline_ns=int(args.deadline_s * NS_PER_SEC),
                n_params=args.params, engine=args.engine, mode=args.mode,
                buffer_k=args.buffer_k, topology=args.topology,
                cells=args.cells, neighbors=args.neighbors)


def run_matrix(args, transports: list[str]) -> tuple[dict, dict, dict]:
    """(deterministic results, wall-clock section, errors)."""
    fleets: dict = {}
    wall: dict = {}
    errors: dict = {}
    for n_clients in args.clients:
        fleets[str(n_clients)] = {"transports": {}}
        wall[str(n_clients)] = {}
        for tr in transports:
            t0 = time.perf_counter()
            try:
                cell = run_fleet(tr, n_clients=n_clients,
                                 **_cell_kwargs(args))
            except Exception as e:  # noqa: BLE001 - a cell failure is a row
                errors[f"{n_clients}/{tr}"] = f"{type(e).__name__}: {e}"
                continue
            wall_s = time.perf_counter() - t0
            fleets[str(n_clients)]["transports"][tr] = cell
            wall[str(n_clients)][tr] = {
                "wall_s": wall_s,
                "rounds_per_wall_sec": args.rounds / wall_s if wall_s else None,
            }
            print(f"fleet_scale/{tr}_c{n_clients},{wall_s * 1e6:.1f},"
                  f"sim_s={cell['sim_time_ns'] / 1e9:.2f}"
                  f";bytes={cell['bytes_on_wire']}"
                  f";retx={cell['retransmissions']}"
                  f";decode_err={sum(r['decode_errors'] for r in cell['rounds'])}"
                  f";bcast_hits={sum(r['bcast_cache_hits'] for r in cell['rounds'])}"
                  f";arrived={sum(r['arrived'] for r in cell['rounds'])}"
                  f"/{sum(r['roster'] for r in cell['rounds'])}"
                  f";loss={cell['final_loss']:.4f}"
                  f";rtt_loss={cell['rounds_to_target_loss']}", flush=True)
    return fleets, wall, errors


def flow_gate(n_clients: int, min_ratio: float, *, rounds: int = 2,
              seed: int = 0) -> dict:
    """Run the same seeded mudp fleet on the batched and flow engines and
    compare simulated packet events per wall second.  The flow engine's
    whole point is per-burst closed forms instead of per-packet events, so
    its event throughput must dominate; *what* it computes is gated
    separately by the distributional tests (``tests/statcheck.py``)."""
    out: dict = {}
    for engine in ("batched", "flow"):
        t0 = time.perf_counter()
        cell = run_fleet("mudp", n_clients=n_clients, rounds=rounds,
                         seed=seed, participation=0.6,
                         deadline_ns=10 * NS_PER_SEC, n_params=2048,
                         engine=engine)
        wall_s = time.perf_counter() - t0
        events = sum(r["packets_sent"] for r in cell["rounds"])
        out[engine] = {"wall_s": wall_s, "packet_events": events,
                       "events_per_sec": events / wall_s if wall_s else 0.0}
    ratio = (out["flow"]["events_per_sec"]
             / out["batched"]["events_per_sec"]
             if out["batched"]["events_per_sec"] else float("inf"))
    out.update(ratio=ratio, min_ratio=min_ratio, ok=ratio >= min_ratio)
    print(f"flow-gate: clients={n_clients} flow/batched events-per-sec "
          f"ratio {ratio:.1f}x (floor {min_ratio:.1f}x)", flush=True)
    return out


#: The report's wall-clock fields outside its ``"wall"`` key, by section.
WALL_FIELDS = {
    "scaling": ("wall_s_total", "wall_s_per_client", "rounds_per_wall_sec"),
    "flow_gate": ("ratio", "ok"),
    "flow_gate/engine": ("wall_s", "events_per_sec"),
}


def reproducible(report: dict) -> dict:
    """The part of a report the simulation decides: all of it but the
    ``"wall"`` key and the wall-clock fields of ``"scaling"`` and
    ``"flow_gate"`` (:data:`WALL_FIELDS`).  Equal, for the same arguments,
    to the same part of the reference's report."""
    out = {k: v for k, v in report.items() if k != "wall"}
    if out.get("scaling") is not None:
        out["scaling"] = [{k: v for k, v in row.items()
                           if k not in WALL_FIELDS["scaling"]}
                          for row in out["scaling"]]
    gate = out.get("flow_gate")
    if gate is not None:
        out["flow_gate"] = {
            k: ({f: x for f, x in v.items()
                 if f not in WALL_FIELDS["flow_gate/engine"]}
                if isinstance(v, dict) else v)
            for k, v in gate.items() if k not in WALL_FIELDS["flow_gate"]}
    return out


def digest(report: dict) -> str:
    """SHA-256 of :func:`reproducible` as canonical JSON (sorted keys, no
    whitespace): the pin of one run."""
    blob = json.dumps(reproducible(report), sort_keys=True,
                      separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


def summary(report: dict) -> dict:
    """A few readable fields of each cell, printed and pinned beside the
    digest: per fleet size and transport the bytes on the wire,
    retransmissions, arrivals over the roster and the final loss."""
    return {f"{n}/{tr}": {
        "bytes_on_wire": cell["bytes_on_wire"],
        "retransmissions": cell["retransmissions"],
        "arrived": sum(r["arrived"] for r in cell["rounds"]),
        "roster": sum(r["roster"] for r in cell["rounds"]),
        "final_loss": cell["final_loss"]}
        for n, sizes in report["fleets"].items()
        for tr, cell in sizes["transports"].items()}


# --------------------------------------------------------------------------
# The reference's reports, pinned (tests/test_torch_fleet_scale.py
# recomputes each from the reference's live run)
# --------------------------------------------------------------------------
#: Small flow runs: every transport under each topology, and one async.
_SMALL = ["--engine", "flow", "--clients", "64", "--rounds", "2"]
PINNED_ARGV = {
    "flow/star": _SMALL + ["--topology", "star"],
    "flow/hier": _SMALL + ["--topology", "hier", "--cells", "4"],
    "flow/gossip": _SMALL + ["--topology", "gossip", "--neighbors", "4"],
    "flow/async": ["--engine", "flow", "--clients", "64", "--rounds", "6",
                   "--mode", "async", "--transports", "mudp,udp"],
    # The deployment the reference's docstring names, one fleet size a run.
    "flow/hier32/10000": ["--engine", "flow", "--topology", "hier",
                          "--cells", "32", "--transports", "mudp",
                          "--clients", "10000", "--rounds", "2"],
    "flow/hier32/100000": ["--engine", "flow", "--topology", "hier",
                           "--cells", "32", "--transports", "mudp",
                           "--clients", "100000", "--rounds", "1"],
}
#: label -> {"sha256": digest(report), "summary": summary(report)}
PINS: dict = {
    "flow/star": {
        "sha256": "f8de91b331502b39d195335e8fd1b518dcdfffc6"
                  "178e103862b68b530ce62c22",
        "summary": {
            "64/mudp": {
                "bytes_on_wire": 1654538, "retransmissions": 240,
                "arrived": 76, "roster": 76,
                "final_loss": 0.06287336349487305},
            "64/mudp+fec": {
                "bytes_on_wire": 1597597, "retransmissions": 51,
                "arrived": 76, "roster": 76,
                "final_loss": 0.06287331879138947},
            "64/tcp": {
                "bytes_on_wire": 1386474, "retransmissions": 34,
                "arrived": 70, "roster": 76,
                "final_loss": 0.06985947489738464},
            "64/udp": {
                "bytes_on_wire": 1278928, "retransmissions": 0,
                "arrived": 76, "roster": 76,
                "final_loss": 0.3499707877635956},
        },
    },
    "flow/hier": {
        "sha256": "310367127fea8982b6aad5a3e5e6baa76cf5c3fd"
                  "8a98d8c946c35e37d0be0790",
        "summary": {
            "64/mudp": {
                "bytes_on_wire": 1884473, "retransmissions": 20,
                "arrived": 8, "roster": 8,
                "final_loss": 0.06279917061328888},
            "64/mudp+fec": {
                "bytes_on_wire": 1854307, "retransmissions": 3,
                "arrived": 8, "roster": 8,
                "final_loss": 0.06279917061328888},
            "64/tcp": {
                "bytes_on_wire": 1585218, "retransmissions": 0,
                "arrived": 8, "roster": 8,
                "final_loss": 0.06929454952478409},
            "64/udp": {
                "bytes_on_wire": 1480864, "retransmissions": 0,
                "arrived": 8, "roster": 8,
                "final_loss": 0.5235349535942078},
        },
    },
    "flow/gossip": {
        "sha256": "9fa249e181dcd19b0768dd49443bf375293a9044"
                  "8c67ea9013ffa8c618c8f41f",
        "summary": {
            "64/mudp": {
                "bytes_on_wire": 6349977, "retransmissions": 872,
                "arrived": 128, "roster": 128,
                "final_loss": 0.06282820552587509},
            "64/mudp+fec": {
                "bytes_on_wire": 6136734, "retransmissions": 145,
                "arrived": 128, "roster": 128,
                "final_loss": 0.06282820552587509},
            "64/tcp": {
                "bytes_on_wire": 5341974, "retransmissions": 94,
                "arrived": 128, "roster": 128,
                "final_loss": 0.06282820552587509},
            "64/udp": {
                "bytes_on_wire": 4981088, "retransmissions": 0,
                "arrived": 128, "roster": 128,
                "final_loss": 0.25836798548698425},
        },
    },
    "flow/async": {
        "sha256": "0475cf2812ad2307319a1fe47023e1ddbd255157"
                  "5a14162f5216bc46bcf1ad70",
        "summary": {
            "64/mudp": {
                "bytes_on_wire": 1536219, "retransmissions": 187,
                "arrived": 48, "roster": 368,
                "final_loss": 0.11043722927570343},
            "64/udp": {
                "bytes_on_wire": 1220030, "retransmissions": 0,
                "arrived": 48, "roster": 368,
                "final_loss": 0.3429051637649536},
        },
    },
    "flow/hier32/10000": {
        "sha256": "ecc255250ba2936ca27773681c1caeb13f8c677b"
                  "898f141d088e5e4467f671ee",
        "summary": {
            "10000/mudp": {
                "bytes_on_wire": 262459155, "retransmissions": 167,
                "arrived": 64, "roster": 64,
                "final_loss": 0.06272412091493607},
        },
    },
    "flow/hier32/100000": {
        "sha256": "0107c2b1dd7a63dff2dac42da3ef14810fac4b56"
                  "02011cbaff2e288bba4f62ee",
        "summary": {
            "100000/mudp": {
                "bytes_on_wire": 1306401101, "retransmissions": 82,
                "arrived": 32, "roster": 32,
                "final_loss": 0.2509077191352844},
        },
    },
}


def profile(trace_path: str, args, transport: str) -> dict:
    """One round of the first fleet size's ``transport`` cell traced with
    ``torch.profiler`` on ``args.device`` (a CUDA device), after one
    untraced round: host wall time, device busy time, idle share and
    device time by kernel (:func:`repro_torch.fl_mnist.trace_summary`)."""
    import torch
    from torch.profiler import ProfilerActivity

    from repro_torch.fl_mnist import trace_summary
    dev = _device.resolve(args.device)
    if dev.type != "cuda":
        raise RuntimeError("profile() measures a CUDA device")
    kw = _cell_kwargs(args)
    kw.pop("rounds")
    with _device.use_device(dev):
        _, system, _, _ = build_cell(transport, n_clients=args.clients[0],
                                     **kw)
        system.run_rounds(1)
        torch.cuda.synchronize()
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            system.run_rounds(1)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    prof.export_chrome_trace(trace_path)
    return {"clients": args.clients[0], "transport": transport,
            "rounds": 1, "wall_s": wall, **trace_summary(trace_path, wall)}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clients", default="100",
                    help="comma-separated fleet sizes (default 100)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--participation", type=float, default=0.6,
                    help="per-round client sampling fraction")
    ap.add_argument("--deadline-s", type=float, default=10.0,
                    help="server round deadline in simulated seconds "
                         "(straggler cutoff)")
    ap.add_argument("--params", type=int, default=2048,
                    help="model size in float32 parameters")
    ap.add_argument("--transports", default=None,
                    help="comma-separated subset (default: every "
                         "registered transport)")
    ap.add_argument("--engine", default="batched",
                    choices=["batched", "per_packet", "flow"],
                    help="simulator engine: batched/per_packet are "
                         "bit-identical; flow is the analytic fast path "
                         "(statistically equivalent, tests/statcheck.py "
                         "gates it), the only engine that reaches "
                         "100k-client fleets in minutes")
    ap.add_argument("--flow-gate", action="store_true",
                    help="run one mudp cell on batched AND flow at "
                         "--flow-gate-clients and fail unless flow "
                         "processes >= --flow-gate-min x the simulated "
                         "packet events per wall second")
    ap.add_argument("--flow-gate-clients", type=int, default=1024,
                    help="fleet size for the --flow-gate comparison")
    ap.add_argument("--flow-gate-min", type=float, default=2.0,
                    help="minimum flow/batched events-per-sec ratio")
    ap.add_argument("--mode", default="sync", choices=["sync", "async"],
                    help="scheduling policy: sync round barrier or "
                         "FedBuff-style async (each row is one buffered "
                         "aggregation; --deadline-s becomes the "
                         "per-session watchdog)")
    ap.add_argument("--buffer-k", type=int, default=8,
                    help="async only: updates buffered per aggregation")
    ap.add_argument("--topology", default="star",
                    choices=["star", "hier", "gossip"],
                    help="fleet wiring: the paper's star, hierarchical "
                         "edge aggregation, or serverless gossip")
    ap.add_argument("--cells", type=int, default=4,
                    help="hier only: number of edge aggregators "
                         "(clamped to the fleet size)")
    ap.add_argument("--neighbors", type=int, default=4,
                    help="gossip only: target peer degree "
                         "(clamped to n_clients - 1)")
    ap.add_argument("--out", default="BENCH_fleet_torch.json",
                    help="report path (the reference writes "
                         "BENCH_fleet.json; the port's default keeps it)")
    ap.add_argument("--replay-check", action="store_true",
                    help="run the matrix twice and fail unless the "
                         "deterministic results are bit-identical")
    ap.add_argument("--device", default=None,
                    help="torch device of the array work (default: cuda)")
    ap.add_argument("--profile", metavar="TRACE_JSON", default=None,
                    help="trace one round of the first fleet size and "
                         "transport on the card with torch.profiler, write "
                         "the chrome trace here and print the device busy "
                         "time and idle share (no report is written)")
    args = ap.parse_args(argv)
    args.clients = [int(c) for c in str(args.clients).split(",") if c]
    if args.rounds < 1 or not args.clients:
        ap.error("--rounds and --clients must be >= 1")
    args.requested = (args.transports.split(",") if args.transports
                      else available_transports())
    for tr in args.requested:
        if tr not in available_transports():
            ap.error(f"unknown transport {tr!r}; registered: "
                     f"{available_transports()}")
    return args


def report_of(args) -> tuple[dict, int]:
    """Run the matrix (and the flow gate, and the replay check) of parsed
    ``args``; returns ``(report, exit code)``."""
    requested = args.requested
    fleets, wall, errors = run_matrix(args, requested)

    # Clients-vs-wall-time scaling: one row per fleet size, total wall
    # across transports, so doubling --clients answers "how does the
    # simulator cost grow?" at a glance.
    scaling = []
    for n in args.clients:
        cells = wall.get(str(n), {})
        total = sum(c["wall_s"] for c in cells.values())
        scaling.append({
            "clients": n,
            "wall_s_total": total,
            "wall_s_per_client": total / n if n else None,
            "rounds_per_wall_sec": (len(cells) * args.rounds / total
                                    if total else None),
        })
        print(f"scaling: clients={n} wall_s={total:.2f} "
              f"wall_s_per_client={total / n:.4f}", flush=True)

    gate = (flow_gate(args.flow_gate_clients, args.flow_gate_min,
                      rounds=args.rounds, seed=args.seed)
            if args.flow_gate else None)

    report = {
        "meta": {
            "clients": args.clients,
            "rounds": args.rounds,
            "seed": args.seed,
            "participation": args.participation,
            "deadline_s": args.deadline_s,
            "params": args.params,
            "transports": requested,
            "engine": args.engine,
            "mode": args.mode,
            "buffer_k": args.buffer_k,
            "topology": args.topology,
            "cells": args.cells,
            "neighbors": args.neighbors,
        },
        "fleets": fleets,
        "errors": errors,
        "wall": wall,
        "scaling": scaling,
        "flow_gate": gate,
    }

    if args.replay_check:
        fleets2, _, errors2 = run_matrix(args, requested)
        if (fleets2, errors2) != (fleets, errors):
            print("REPLAY CHECK FAILED: results differ between two runs "
                  "with the same seed", file=sys.stderr)
            return report, 2
        print("replay-check: bit-identical across two runs", flush=True)

    # No transport may be silently skipped: every requested transport must
    # have produced a result cell for every fleet size.
    missing = [f"{n}/{tr}" for n in fleets for tr in requested
               if tr not in fleets[n]["transports"]]
    if missing or errors:
        for key in missing:
            print(f"MISSING RESULT: {key}", file=sys.stderr)
        for key, err in errors.items():
            print(f"TRANSPORT ERROR: {key}: {err}", file=sys.stderr)
        return report, 1
    if gate is not None and not gate["ok"]:
        print(f"FLOW GATE FAILED: flow/batched events-per-sec ratio "
              f"{gate['ratio']:.2f} < {gate['min_ratio']}", file=sys.stderr)
        return report, 1
    return report, 0


def main(argv=None) -> int:
    args = parse_args(argv)
    with _device.use_device(_device.resolve(args.device)):
        if args.profile:
            print(json.dumps(profile(args.profile, args,
                                     args.requested[0])))
            return 0
        report, rc = report_of(args)
    if rc == 2:
        return rc
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1, sort_keys=True)
    print(f"wrote {args.out}", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
