"""The gates of the reference's three fleet benchmarks, on the port.

Each function runs what its reference benchmark runs and returns its
report with a list of gate failures (empty when every gate holds):

* :func:`topology_gate` (``benchmarks/topology_bench.py``): one seeded
  64-client fleet training the consensus objective under ``star``,
  ``hier`` at 2, 4 and 8 cells and ``gossip`` at degree 4.  Gates: the
  root link linear in cells (per-aggregator root bytes within 1.6x of
  each other, and each hier root link within [0.4, 2.5]x the star's
  server link x cells / clients); hier's final loss within 2% of L0 of
  star's; gossip with zero server nodes reaching 10% of L0.
* :func:`async_gate` (``benchmarks/async_vs_sync.py``): a 32-client
  congested-edge fleet, sync against async.  Gate: async reaches 5% of
  L0 in at most 0.8x the simulated time sync takes.
* :func:`compute_matrix` and :func:`learning_curve`
  (``benchmarks/vmap_train.py``): one full local-training batch of the
  MLP at 16 / 64 / 256 clients through the ``python`` per-client loop
  and the one-call ``vmap`` backend (the reference's gate: vmap >= 5x
  the loop at 256 clients); and a 16-client non-IID (dirichlet alpha
  0.5) MNIST fleet over ``mudp`` with every link dropping 10% of
  packets, trained by the vmap backend.  Gate: test accuracy >= 0.95
  within 20 rounds.  The MNIST is the seeded synthetic set unless a
  local IDX directory is given; nothing is downloaded.

Everything runs on ``device`` (default: ``cuda``); ``--engine`` picks
the simulator engine of the topology and async gates (``flow``: the
analytic engine of :mod:`repro_torch.core.flow`):

    PYTHONPATH=src python -m repro_torch.fleet_gates --device cpu --check
    PYTHONPATH=src python -m repro_torch.fleet_gates --device cpu \
        --only topology,async --engine flow
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core.client_compute import make_model, make_train_backend
from repro_torch.core.fleet import (CohortSpec, ConsensusObjective,
                                    FleetConfig, build_fleet,
                                    build_fleet_training, profiles_digest)
from repro_torch.core.packetizer import flatten_to_vector
from repro_torch.core.rounds import FLConfig
from repro_torch.core.transport import TransportConfig

NS = 1_000_000_000

#: Smoke-scale MLP for the compute matrix (the reference's): small enough
#: that per-client dispatch dominates, the regime batching exists for.
MATRIX_MODEL_ARGS = {"hidden": 16, "batch_size": 16, "local_steps": 1,
                     "shard_size": 128}
#: The paper's full-width MLP (784-32-10), the learning curve's model.
CURVE_MODEL_ARGS = {"hidden": 32, "batch_size": 32, "local_steps": 4,
                    "shard_size": 256, "alpha": 0.5}
MIN_SPEEDUP = 5.0
TARGET_ACC = 0.95

#: Every client on a 10%-loss link: the paper's lossy regime, uniform so
#: the curve measures the transport, not cohort luck.
LOSSY10 = CohortSpec(
    name="lossy10",
    up_rate_bps=(20e6, 20e6),
    down_up_ratio=2.0,
    delay_ns=(5_000_000, 20_000_000),
    jitter_frac=0.3,
    loss_p=(0.10, 0.10),
    bursty=False,
    train_time_ns=(200_000_000, 800_000_000),
)


# --------------------------------------------------------------------------
# topology_bench
# --------------------------------------------------------------------------
def run_topology(topology: str, *, n_clients: int, rounds: int, seed: int,
                 n_params: int, transport: str, cells: int = 4,
                 neighbors: int = 4, engine: str = "batched") -> dict:
    """One topology cell: every field derives from the simulation."""
    fleet = FleetConfig(n_clients=n_clients, seed=seed, engine=engine,
                        topology=topology, cells=cells, neighbors=neighbors)
    objective = ConsensusObjective(n_clients, n_params, seed=seed)
    fl_cfg = FLConfig(transport=TransportConfig(
        kind=transport, timeout_ns=2 * NS, udp_deadline_ns=3 * NS))
    sim, system, profiles = build_fleet(fleet, objective.init_params(),
                                        objective.train_fn, fl_cfg)
    loss0 = objective.loss(system.global_params)
    rows, losses = [], []

    def _on_round(r, params):
        loss = objective.loss(params)
        losses.append(loss)
        rows.append({"round": r.round_idx, "duration_ns": r.duration_ns,
                     "arrived": len(r.arrived), "roster": len(r.roster),
                     "bytes_sent": r.bytes_sent,
                     "retransmissions": r.retransmissions, "loss": loss})

    system.on_round_end = _on_round
    system.run_rounds(rounds)
    server_nodes = sum(1 for addr in sim._nodes
                       if addr == fleet.server_addr
                       or addr.startswith("10.2."))   # edge server planes
    return {
        "topology": topology,
        "cells": cells if topology == "hier" else None,
        "neighbors": neighbors if topology == "gossip" else None,
        "profiles_digest": profiles_digest(profiles),
        "rounds": rows,
        "hop_bytes": dict(sorted(sim.hop_bytes.items())),
        "server_nodes": server_nodes,
        "sim_time_ns": sum(r["duration_ns"] for r in rows),
        "initial_loss": loss0,
        "final_loss": losses[-1] if losses else loss0,
        "rounds_to_target_loss": next(
            (i + 1 for i, v in enumerate(losses) if v <= 0.1 * loss0), None),
    }


def topology_gate(*, clients: int = 64, rounds: int = 3, seed: int = 0,
                  params: int = 1024, transport: str = "mudp",
                  cells: tuple = (2, 4, 8), neighbors: int = 4,
                  engine: str = "batched") -> tuple[dict, list[str]]:
    """Star, hier at each of ``cells`` and gossip on one seeded fleet;
    returns ``(cells by key, gate failures)``."""
    common = dict(n_clients=clients, rounds=rounds, seed=seed,
                  n_params=params, transport=transport, engine=engine,
                  neighbors=neighbors)
    results = {"star": run_topology("star", **common)}
    for c in cells:
        results[f"hier_cells{c}"] = run_topology("hier", cells=c, **common)
    results[f"gossip_k{neighbors}"] = run_topology("gossip", **common)
    star, gossip = results["star"], results[f"gossip_k{neighbors}"]
    hier = {c: results[f"hier_cells{c}"] for c in cells}

    failures: list[str] = []
    loss0 = star["initial_loss"]
    per_agg = {c: hier[c]["hop_bytes"]["edge->root"] / c for c in cells}
    if max(per_agg.values()) > 1.6 * min(per_agg.values()):
        failures.append(f"root-link bytes not ~linear in aggregator count: "
                        f"per-aggregator bytes {per_agg}")
    star_link = star["hop_bytes"]["client->server"]
    for c in cells:
        expect = star_link * c / clients
        got = hier[c]["hop_bytes"]["edge->root"]
        if not 0.4 * expect <= got <= 2.5 * expect:
            failures.append(f"hier cells={c}: root link {got}B not "
                            f"~{expect:.0f}B (= star server link x "
                            f"cells/clients)")
    for c in cells:
        gap = abs(hier[c]["final_loss"] - star["final_loss"])
        if gap > 0.02 * loss0:
            failures.append(f"hier cells={c}: final loss "
                            f"{hier[c]['final_loss']:.6f} != star "
                            f"{star['final_loss']:.6f} (gap {gap:.2e})")
    if gossip["server_nodes"] != 0:
        failures.append(f"gossip wired {gossip['server_nodes']} server "
                        f"nodes; expected 0")
    if gossip["rounds_to_target_loss"] is None:
        failures.append(f"gossip never reached 10% of initial loss "
                        f"(final {gossip['final_loss']:.4f} vs initial "
                        f"{gossip['initial_loss']:.4f})")
    return results, failures


# --------------------------------------------------------------------------
# async_vs_sync
# --------------------------------------------------------------------------
def time_to_target(mode: str, *, n_clients: int, seed: int,
                   target_frac: float, n_params: int, max_rounds: int,
                   transport: str, buffer_k: int, deadline_ns: int,
                   engine: str = "batched") -> dict:
    """Run one mode until the loss target is crossed (or max_rounds)."""
    fleet = FleetConfig(n_clients=n_clients, seed=seed, mode=mode,
                        buffer_k=buffer_k, engine=engine,
                        cohort_mix=(("congested-edge", 1.0),),
                        round_deadline_ns=deadline_ns)
    objective = ConsensusObjective(n_clients, n_params, seed=seed)
    cfg = FLConfig(aggregation="fedavg",
                   transport=TransportConfig(kind=transport,
                                             timeout_ns=2 * NS,
                                             udp_deadline_ns=3 * NS))
    sim, system, _ = build_fleet(fleet, objective.init_params(),
                                 objective.train_fn, cfg)
    loss0 = objective.loss(system.global_params)
    target = target_frac * loss0
    trace: list[dict] = []

    def on_round(res, params):
        trace.append({"round": res.round_idx, "sim_ns": sim.now_ns,
                      "loss": objective.loss(params),
                      "arrived": len(res.arrived)})
    system.on_round_end = on_round
    t0 = time.perf_counter()
    system.run_rounds(max_rounds)
    wall_s = time.perf_counter() - t0
    crossed = next((row for row in trace if row["loss"] <= target), None)
    return {
        "mode": mode, "initial_loss": loss0, "target_loss": target,
        "rounds_run": len(trace),
        "rounds_to_target": crossed["round"] + 1 if crossed else None,
        "sim_ns_to_target": crossed["sim_ns"] if crossed else None,
        "final_loss": trace[-1]["loss"] if trace else loss0,
        "trace": trace, "wall_s": wall_s,
    }


def async_gate(*, clients: int = 32, seed: int = 0,
               target_frac: float = 0.05, params: int = 2048,
               max_rounds: int = 20, transport: str = "mudp",
               buffer_k: int = 8, deadline_s: float = 8.0,
               engine: str = "batched") -> tuple[dict, list[str]]:
    """Sync for ``max_rounds`` rounds against async for 8x as many
    aggregations; returns ``(report, gate failures)``."""
    kw = dict(n_clients=clients, seed=seed, target_frac=target_frac,
              n_params=params, transport=transport, buffer_k=buffer_k,
              deadline_ns=int(deadline_s * NS), engine=engine)
    sync = time_to_target("sync", max_rounds=max_rounds, **kw)
    async_ = time_to_target("async", max_rounds=8 * max_rounds, **kw)
    ratio = None
    if sync["sim_ns_to_target"] and async_["sim_ns_to_target"]:
        ratio = async_["sim_ns_to_target"] / sync["sim_ns_to_target"]
    failures = []
    if ratio is None:
        failures.append("a mode never crossed the target loss")
    elif ratio > 0.8:
        failures.append(f"async/sync = {ratio:.3f} > 0.8")
    return ({"sync": sync, "async": async_,
             "time_ratio_async_over_sync": ratio}, failures)


# --------------------------------------------------------------------------
# vmap_train
# --------------------------------------------------------------------------
def _time_call(fn, dev: torch.device, budget_s: float) -> tuple[float, int]:
    def call():
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    call()                                  # warm (first kernels, caches)
    t0 = time.perf_counter()
    reps = 0
    while time.perf_counter() - t0 < budget_s:
        call()
        reps += 1
    return (time.perf_counter() - t0) / reps, reps


def matrix_inputs(model, k: int) -> tuple[np.ndarray, np.ndarray,
                                          np.ndarray]:
    """The matrix's batch: k copies of the initial model, clients 0..k-1,
    round 0."""
    vec0 = flatten_to_vector(model.init_params())
    return (np.tile(vec0, (k, 1)), np.arange(k, dtype=np.int32),
            np.zeros(k, np.int32))


def compute_matrix(client_counts, *, seed: int = 0, budget_s: float = 1.0,
                   model_args: Optional[dict] = None,
                   device: _device.DeviceLike | None = None) -> list[dict]:
    """ms per full-batch local-training call, python loop vs vmap, at
    each of ``client_counts`` (``model_args`` default: the reference's
    smoke-scale MLP)."""
    dev = _device.resolve(device)
    model = make_model("mlp", max(client_counts), seed=seed, device=dev,
                       **(MATRIX_MODEL_ARGS if model_args is None
                          else model_args))
    rows = []
    for k in client_counts:
        stack, ci, ri = matrix_inputs(model, k)
        timings = {}
        for name in ("python", "vmap"):
            backend = make_train_backend(name)
            s, reps = _time_call(
                lambda: backend.train(model, stack, ci, ri), dev, budget_s)
            timings[name] = s
            rows.append({"clients": k, "backend": name,
                         "ms_per_call": s * 1e3,
                         "us_per_client": s * 1e6 / k, "reps": reps,
                         "n_params": model.n_params})
        for row in rows[-2:]:
            row["speedup_vs_python"] = (timings["python"]
                                        / timings[row["backend"]])
    return rows


def learning_curve(*, seed: int = 0, n_clients: int = 16,
                   max_rounds: int = 20, transport: str = "mudp",
                   backend: str = "vmap", data_dir: Optional[str] = None,
                   device: _device.DeviceLike | None = None) -> dict:
    """Non-IID MNIST over a uniformly 10%-lossy fleet, vmap backend."""
    dev = _device.resolve(device)
    with _device.use_device(dev):
        fleet = FleetConfig(
            n_clients=n_clients, seed=seed,
            cohorts={"lossy10": LOSSY10}, cohort_mix=(("lossy10", 1.0),),
            model="mlp", train_backend=backend,
            model_args=dict(CURVE_MODEL_ARGS, data_dir=data_dir))
        fl_cfg = FLConfig(
            aggregation="fedavg",
            transport=TransportConfig(kind=transport, timeout_ns=2 * NS,
                                      udp_deadline_ns=3 * NS))
        build = build_fleet_training(fleet, fl_cfg)
        model, system = build.model, build.system
        curve = []
        t0 = time.perf_counter()
        for r in range(max_rounds):
            res = system.run_round()
            curve.append({"round": r + 1,
                          "accuracy": model.accuracy(system.global_params),
                          "loss": model.loss(system.global_params),
                          "arrived": len(res.arrived),
                          "bytes_sent": res.bytes_sent,
                          "retransmissions": res.retransmissions})
        wall = time.perf_counter() - t0
    return {
        "transport": transport, "n_clients": n_clients, "loss_p": 0.10,
        "alpha": CURVE_MODEL_ARGS["alpha"], "data_source": model.data.source,
        "init_accuracy": model.accuracy(model.init_params()),
        "final_accuracy": curve[-1]["accuracy"], "curve": curve,
        "batch_sizes": (build.trainer.batch_sizes
                        if build.trainer is not None else None),
        "wall_s": wall,
    }


def rounds_to_accuracy(curve: list[dict], target: float) -> Optional[int]:
    for row in curve:
        if row["accuracy"] >= target:
            return row["round"]
    return None


# --------------------------------------------------------------------------
# The harness's suites (repro_torch.bench_run): each the reference
# benchmark's bench(), row names and derived fields as it prints them.
# --------------------------------------------------------------------------
def bench_topology(rounds: int = 2):
    """``benchmarks/topology_bench.py``'s ``bench()``: one small cell per
    topology."""
    rows = []
    for topology, kw in (("star", {}), ("hier", {"cells": 4}),
                         ("gossip", {"neighbors": 3})):
        t0 = time.perf_counter()
        cell = run_topology(topology, n_clients=16, rounds=rounds, seed=0,
                            n_params=1024, transport="mudp", **kw)
        wall_us = (time.perf_counter() - t0) * 1e6
        root = (cell["hop_bytes"].get("edge->root")
                or cell["hop_bytes"].get("client->server")
                or cell["hop_bytes"].get("peer->peer"))
        rows.append((f"topology/{topology}_c16", wall_us,
                     f"loss={cell['final_loss']:.4f}"
                     f";root_bytes={root}"
                     f";server_nodes={cell['server_nodes']}"))
    return rows


def bench_async_vs_sync():
    """``benchmarks/async_vs_sync.py``'s ``bench()``: one small
    comparison cell."""
    report, _ = async_gate(clients=16, seed=0, target_frac=0.1, params=1024,
                           max_rounds=8, transport="mudp", buffer_k=4,
                           deadline_s=8.0, engine="batched")
    rows = []
    for mode in ("sync", "async"):
        cell = report[mode]
        rows.append((f"async_vs_sync/{mode}_c16",
                     cell["wall_s"] * 1e6,
                     f"sim_s_to_target="
                     f"{(cell['sim_ns_to_target'] or 0) / 1e9:.2f}"
                     f";rounds={cell['rounds_to_target']}"
                     f";final_loss={cell['final_loss']:.4f}"))
    ratio = report["time_ratio_async_over_sync"]
    rows.append(("async_vs_sync/ratio", 0.0,
                 f"async/sync={ratio:.3f}" if ratio else "no_crossing"))
    return rows


def bench_vmap_train():
    """``benchmarks/vmap_train.py``'s ``bench()``: the small end of the
    compute matrix."""
    for row in compute_matrix([16, 64], budget_s=0.3):
        yield (f"vmap_train/{row['backend']}_{row['clients']}c",
               row["ms_per_call"] * 1e3,
               f"speedup={row['speedup_vs_python']:.2f}x")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default="topology,async,vmap",
                    help="comma-separated gates to run")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--clients", type=int, nargs="+", default=[16, 64, 256],
                    help="compute-matrix client counts")
    ap.add_argument("--budget-s", type=float, default=1.0,
                    help="timing budget per matrix cell")
    ap.add_argument("--data-dir", default=None,
                    help="a local MNIST IDX directory for the curve "
                         "(default: the seeded synthetic set)")
    ap.add_argument("--engine", default="batched",
                    choices=["batched", "per_packet", "flow"],
                    help="simulator engine of the topology and async "
                         "gates (flow: the analytic engine)")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 unless the held gates pass (the 5x "
                         "speedup is printed, not held)")
    args = ap.parse_args(argv)
    only = set(args.only.split(","))
    failures: list[str] = []
    with _device.use_device(_device.resolve(args.device)):
        if "topology" in only:
            results, fail = topology_gate(engine=args.engine)
            for key, cell in results.items():
                root = (cell["hop_bytes"].get("edge->root")
                        or cell["hop_bytes"].get("client->server")
                        or cell["hop_bytes"].get("peer->peer"))
                print(f"topology/{key}: loss={cell['final_loss']:.4f} "
                      f"root_bytes={root} "
                      f"server_nodes={cell['server_nodes']}")
            failures += fail
        if "async" in only:
            report, fail = async_gate(engine=args.engine)
            for mode in ("sync", "async"):
                cell = report[mode]
                print(f"{mode:>5}: L0={cell['initial_loss']:.3f} -> target "
                      f"{cell['target_loss']:.4f} in "
                      f"{cell['rounds_to_target']} rounds, sim t="
                      f"{(cell['sim_ns_to_target'] or 0) / 1e9:.2f}s")
            print(f"async/sync = {report['time_ratio_async_over_sync']}")
            failures += fail
        if "vmap" in only:
            for row in compute_matrix(args.clients, budget_s=args.budget_s):
                print(f"clients={row['clients']:>4} {row['backend']:<7} "
                      f"{row['ms_per_call']:8.2f} ms/call  "
                      f"speedup={row['speedup_vs_python']:.2f}x "
                      f"(reference gate {MIN_SPEEDUP}x)")
            curve = learning_curve(data_dir=args.data_dir)
            hit = rounds_to_accuracy(curve["curve"], TARGET_ACC)
            print(f"learning curve ({curve['data_source']} data): final acc "
                  f"{curve['final_accuracy']:.4f}; {TARGET_ACC} reached "
                  f"{'at round ' + str(hit) if hit else 'NEVER'}")
            if hit is None:
                failures.append(f"accuracy {curve['final_accuracy']:.4f} "
                                f"< {TARGET_ACC} after 20 rounds")
    for msg in failures:
        print(f"GATE FAILED: {msg}", file=sys.stderr)
    print(json.dumps({"gate_failures": failures}))
    return 1 if (args.check and failures) else 0


if __name__ == "__main__":
    sys.exit(main())
