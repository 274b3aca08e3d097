"""The simulator core on the port: the batched flight engine against the
per-packet one.

The counterpart of the reference's ``benchmarks/simcore.py``.  Two
workloads on the standard heterogeneous fleet (cohort link draws, jitter
and loss identical across engines):

* ``fleet_burst``: every client ships one ``--payload-kib`` update to the
  server through the transport (packets built outside the timed region:
  the event engine alone);
* ``fl_round``: one whole FL round (broadcast, local training, uplink,
  FedAvg of the consensus objective at ``--params`` parameters on the
  device: the fedavg kernel at (clients, params)).

Every (workload, transport) cell runs under both engines; their replay
digests (the simulator's stats and final clock, and the delivered
payloads or the global model's leading bytes) must be equal, and at the
reference CI's arguments (``--clients 64 --payload-kib 256``, the default
``--params`` and ``--seed``) each must equal the reference's (:data:`PINS`).
Speedups and events per wall second are recorded with no floor unless
``--min-speedup`` asks for one.  The report goes to ``--out`` (default
``build/port_bench/simcore.json``).

    PYTHONPATH=src python -m repro_torch.simcore --device cpu \\
        --clients 64 --payload-kib 256 --repeats 2
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

from repro_torch import device as _device
from repro_torch.core.fleet import (ConsensusObjective, FleetConfig,
                                    build_fleet, links_for, sample_profiles)
from repro_torch.core.packetizer import packetize
from repro_torch.core.rounds import FLConfig
from repro_torch.core.simulator import Simulator
from repro_torch.core.transport import (TransportConfig, available_transports,
                                        make_transport)

NS = 1_000_000_000
SERVER = "10.0.0.1"
DEFAULT_OUT = os.path.join("build", "port_bench", "simcore.json")


def fleet_burst(engine: str, transport: str, *, n_clients: int,
                payload: int, seed: int) -> dict:
    """Every client uplinks one ``payload``-byte update through
    ``transport`` over its drawn fleet link; returns engine metrics."""
    profiles = sample_profiles(FleetConfig(n_clients=n_clients, seed=seed))
    sim = Simulator(engine=engine)
    for p in profiles:
        up, down = links_for(p)
        sim.connect(p.addr, SERVER, up, down)
    tr = make_transport(transport)
    cfg = TransportConfig(kind=transport, timeout_ns=16 * NS,
                          udp_deadline_ns=24 * NS)
    deliveries: list = []
    tr.create_receiver(sim, sim.node(SERVER), cfg, deliveries.append)
    data = bytes(range(256)) * (payload // 256)
    bursts = [packetize(data, p.addr, txn=1, mtu=cfg.mtu) for p in profiles]
    senders = [tr.create_sender(sim, sim.node(p.addr), sim.node(SERVER),
                                pkts, cfg)
               for p, pkts in zip(profiles, bursts)]
    t0 = time.perf_counter()
    for s in senders:
        s.start()
    sim.run()
    wall_s = time.perf_counter() - t0
    payload_hash = hashlib.sha256()
    for blob in sorted((d.sender_addr.encode() + d.reassemble())
                       for d in deliveries):
        payload_hash.update(blob)
    return {
        "wall_s": wall_s,
        "events": sim.events_processed,
        "events_per_sec": sim.events_processed / wall_s if wall_s else None,
        "packets_sent": sim.stats["packets_sent"],
        "packets_delivered": sim.stats["packets_delivered"],
        "deliveries": len(deliveries),
        "digest": sim.stats_digest() + payload_hash.hexdigest()[:16],
    }


def fl_round(engine: str, transport: str, *, n_clients: int,
             n_params: int, seed: int) -> dict:
    """One full FL round on the fleet scenario engine."""
    fleet = FleetConfig(n_clients=n_clients, seed=seed,
                        participation_fraction=1.0,
                        round_deadline_ns=120 * NS, engine=engine)
    objective = ConsensusObjective(n_clients, n_params, seed=seed)
    cfg = FLConfig(aggregation="fedavg",
                   transport=TransportConfig(kind=transport,
                                             timeout_ns=8 * NS,
                                             udp_deadline_ns=12 * NS))
    sim, system, _ = build_fleet(fleet, objective.init_params(),
                                 objective.train_fn, cfg)
    t0 = time.perf_counter()
    r = system.run_round()
    wall_s = time.perf_counter() - t0
    return {
        "wall_s": wall_s,
        "events": sim.events_processed,
        "events_per_sec": sim.events_processed / wall_s if wall_s else None,
        "packets_sent": r.packets_sent,
        "data_packets": r.data_packets,
        "nack_packets": r.nack_packets,
        "parity_packets": r.parity_packets,
        "digest": (sim.stats_digest()
                   + system.global_params["w"].tobytes().hex()[:32]),
    }


WORKLOADS = {"fleet_burst": fleet_burst, "fl_round": fl_round}


def run_cell(workload: str, transport: str, *, n_clients: int, payload: int,
             n_params: int, seed: int, repeats: int) -> dict:
    """One (workload, transport) cell under both engines; best-of-N wall,
    plus the digest-equality verdict."""
    cell: dict = {}
    for engine in ("per_packet", "batched"):
        best = None
        for _ in range(repeats):
            if workload == "fleet_burst":
                m = fleet_burst(engine, transport, n_clients=n_clients,
                                payload=payload, seed=seed)
            else:
                m = fl_round(engine, transport, n_clients=n_clients,
                             n_params=n_params, seed=seed)
            if best is None or m["wall_s"] < best["wall_s"]:
                best = m
        cell[engine] = best
    pp, ba = cell["per_packet"], cell["batched"]
    cell["digests_match"] = pp["digest"] == ba["digest"]
    cell["speedup_events_per_sec"] = (
        ba["events_per_sec"] / pp["events_per_sec"]
        if pp["events_per_sec"] else None)
    return cell


def bench():
    """``(row name, wall us, derived fields)``, as the reference's
    ``bench()``: a small burst, both engines."""
    rows = []
    for tr in ("mudp", "udp"):
        cell = run_cell("fleet_burst", tr, n_clients=16, payload=128 * 1024,
                        n_params=1024, seed=0, repeats=1)
        rows.append((
            f"simcore/{tr}_burst_c16",
            cell["batched"]["wall_s"] * 1e6,
            f"speedup={cell['speedup_events_per_sec']:.2f}x"
            f";eps={cell['batched']['events_per_sec']:.0f}"
            f";identical={cell['digests_match']}"))
    return rows


#: The reference's digests at its CI arguments, by (workload, transport).
PINNED_META = {"clients": 64, "payload_kib": 256, "params": 32768, "seed": 0}
PINS = {
    "fl_round": {
        "mudp": "5c36d59dd81e68370a02defa92ed5f1bbc9c71ff88782075"
            "109f6540c8671d4d1b30863de06588bd9b33a23e90164d3d",
        "mudp+fec": "63891824f894ac757f66baa854dcb57c6602995f9e3b29da"
            "e4e7f72dbc939e1b1b30863ddf6588bd9b33a23e90164d3d",
        "tcp": "ad05c5c0294d8a3501dc15d06aec2930241b70dc97bf1538"
            "edc1dce61785986726e8803d77ff89bdad15a33e5c8b403d",
        "udp": "22c2ddaca8dd6016ef2987f065f31a020addcce0898ab3f4"
            "5dd7cade21e608db1d30863dde6588bd9c33a23e90164d3d",
    },
    "fleet_burst": {
        "mudp": "3bb4fb556ae3fe38eee670c0f34c19211ffb3cbfdbc71b87"
            "86d24978a21ac2f64947dd8a49b20fcd",
        "mudp+fec": "14c060a7f73ce1bbe92f6a56ef2e31981477595398f8f7f9"
            "4548f6b20a3ea34b4947dd8a49b20fcd",
        "tcp": "1fc1f580e406766b046051f93cf62450364ceacdd1e86708"
            "ce5d9de476b0977f4947dd8a49b20fcd",
        "udp": "8533fe61ad62db010eab544309fc18e6e664c51857be0f23"
            "680da7c3c29358e4ba51960050dae944",
    },
}


def run(*, clients: int = 64, payload_kib: int = 1024, params: int = 32768,
        seed: int = 0, repeats: int = 3, transports=None, workloads=None,
        min_speedup: float = 0.0) -> tuple[dict, list[str]]:
    """The matrix: ``(report, failures)``: an engine divergence, a digest
    off its pin (at :data:`PINNED_META`), a missed ``min_speedup``."""
    transports = list(transports or ("mudp", "udp", "mudp+fec", "tcp"))
    workloads = list(workloads or WORKLOADS)
    meta = {"clients": clients, "payload_kib": payload_kib,
            "params": params, "seed": seed}
    report: dict = {"meta": dict(meta, repeats=repeats,
                                 transports=transports,
                                 workloads=workloads),
                    "cells": {}}
    failures = []
    pinned = meta == PINNED_META
    for w in workloads:
        report["cells"][w] = {}
        for tr in transports:
            cell = run_cell(w, tr, n_clients=clients,
                            payload=payload_kib * 1024, n_params=params,
                            seed=seed, repeats=repeats)
            report["cells"][w][tr] = cell
            if not cell["digests_match"]:
                failures.append(f"engine divergence: {w}/{tr}")
            if pinned and cell["batched"]["digest"] != PINS[w][tr]:
                failures.append(f"{w}/{tr}: digest "
                                f"{cell['batched']['digest']} != pinned "
                                f"{PINS[w][tr]}")
    best_burst = max(
        (c["speedup_events_per_sec"] or 0.0
         for c in report["cells"].get("fleet_burst", {}).values()),
        default=0.0)
    report["best_fleet_burst_speedup"] = best_burst
    report["pinned"] = pinned
    if min_speedup and best_burst < min_speedup:
        failures.append(f"best fleet_burst speedup {best_burst:.2f}x < "
                        f"{min_speedup}x")
    return report, failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clients", type=int, default=64)
    ap.add_argument("--payload-kib", type=int, default=1024,
                    help="fleet_burst: update size per client (KiB)")
    ap.add_argument("--params", type=int, default=32768,
                    help="fl_round: model size in float32 parameters")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeats", type=int, default=3,
                    help="timing repeats per cell (best wall kept)")
    ap.add_argument("--transports", default="mudp,udp,mudp+fec,tcp",
                    help="comma-separated subset of registered transports")
    ap.add_argument("--workloads", default="fleet_burst,fl_round")
    ap.add_argument("--min-speedup", type=float, default=0.0,
                    help="fail unless the best fleet_burst speedup reaches "
                         "this factor")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    transports = [t for t in args.transports.split(",") if t]
    for t in transports:
        if t not in available_transports():
            ap.error(f"unknown transport {t!r}; registered: "
                     f"{available_transports()}")
    workloads = [w for w in args.workloads.split(",") if w]
    for w in workloads:
        if w not in WORKLOADS:
            ap.error(f"unknown workload {w!r}; one of {sorted(WORKLOADS)}")
    with _device.use_device(_device.resolve(args.device)):
        report, failures = run(
            clients=args.clients, payload_kib=args.payload_kib,
            params=args.params, seed=args.seed, repeats=args.repeats,
            transports=transports, workloads=workloads,
            min_speedup=args.min_speedup)
    for w, cells in report["cells"].items():
        for tr, cell in cells.items():
            print(f"simcore/{w}/{tr}: "
                  f"per_packet={cell['per_packet']['wall_s']:.3f}s "
                  f"batched={cell['batched']['wall_s']:.3f}s "
                  f"speedup={cell['speedup_events_per_sec']:.2f}x "
                  f"eps={cell['batched']['events_per_sec']:,.0f} "
                  f"identical={cell['digests_match']}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1, sort_keys=True)
    print(f"wrote {args.out}")
    for msg in failures:
        print(f"GATE FAILED: {msg}", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
