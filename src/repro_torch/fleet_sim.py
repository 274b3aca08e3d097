"""Fleet-scale scenario on the port: 48 heterogeneous clients around one
server, MUDP vs the UDP baseline, or the adaptive transport control plane.

The counterpart of the reference's ``examples/fleet_sim.py`` for what the
port serves so far: a seeded cohort draw (fiber / lte / congested-edge),
full participation, a 4-simulated-second round deadline (straggler
cutoff, late updates folded into the next round) and weighted FedAvg
over whatever arrived, on the ``star`` topology under sync scheduling.

``--model`` picks what the clients train: ``consensus`` (the analytic
objective of :class:`~repro_torch.core.fleet.ConsensusObjective`) or
``mlp`` (the paper's 784-32-10 MNIST MLP on non-IID dirichlet shards,
trained on the device; prints test accuracy per round).

``--control static`` runs the ``mudp`` and ``udp`` arms with raw weights
on the wire.  ``--control adaptive`` runs ``mudp+fec`` with a
``delta|ef|topk(0.15)|int8(1024)`` uplink and an ``int8(1024)`` downlink,
and the server walks each client along the loss-driven ladder of
:class:`~repro_torch.core.control.AdaptivePolicy` (``topk`` 0.4 / 0.15 /
0.04 with FEC parity 0 / 1 / 2); each round then also prints how many
clients sit on each tier.  On this path every client's uplink encode runs
the top-k gather and quantize kernels, and the server's batch decode the
dequantize and top-k scatter kernels, before the fedavg kernel folds the
arrived rows.

What waits for later slices of the port is refused with an error:
``--mode async``, ``--topology hier|gossip`` and ``--train-backend
vmap|shard``.  Runs go to ``cuda`` unless ``--device`` names another
device; without a card, ``cuda`` raises.

    PYTHONPATH=src python -m repro_torch.fleet_sim --device cpu \\
        --model mlp --control adaptive --rounds 3
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional

from repro_torch import device as _device
from repro_torch.core.fleet import (FleetBuild, FleetConfig,
                                    build_fleet_training, cohort_counts)
from repro_torch.core.rounds import FLConfig
from repro_torch.core.transport import TransportConfig

N_CLIENTS = 48
SEED = 7
ROUNDS = 3                          # the reference's sync horizon
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

#: What this slice refuses, flag -> {value: what it waits for}.
_NOT_PORTED = {
    "mode": {"async": "the async scheduler", "both": "the async scheduler"},
    "topology": {"hier": "the hier topology", "gossip": "the gossip "
                 "topology"},
    "train_backend": {"vmap": "the vmap train backend",
                      "shard": "the shard train backend"},
}


def configs(transport: str = "mudp+fec", *, n_clients: int = N_CLIENTS,
            model: str = "mlp", control: str = "adaptive",
            model_args: Optional[dict] = None
            ) -> tuple[FleetConfig, FLConfig]:
    """The fleet and FL configurations of one arm (the reference's
    ``examples/fleet_sim.py`` sync/star arm)."""
    adaptive = control == "adaptive"
    wire = {"uplink": UPLINK, "downlink": DOWNLINK} if adaptive else {}
    fleet = FleetConfig(n_clients=n_clients, seed=SEED, mode="sync",
                        round_deadline_ns=4 * NS, topology="star",
                        model=model, model_args=model_args,
                        train_backend="python", control=control)
    cfg = FLConfig(aggregation="fedavg",
                   transport=TransportConfig(kind=transport,
                                             timeout_ns=2 * NS,
                                             udp_deadline_ns=3 * NS,
                                             **wire))
    return fleet, cfg


def tier_counts(build: FleetBuild) -> Optional[list[int]]:
    """Clients on each rung of the adaptive ladder (None without one)."""
    policy = build.system.core.controller
    if policy is None or not hasattr(policy, "tier_of"):
        return None
    counts = [0] * len(policy.tiers)
    for p in build.profiles:
        counts[policy.tier_of(p.addr)] += 1
    return counts


def build(transport: str = "mudp+fec", *, n_clients: int = N_CLIENTS,
          model: str = "mlp", control: str = "adaptive",
          model_args: Optional[dict] = None,
          device: _device.DeviceLike | None = None) -> FleetBuild:
    """One arm, wired and not yet run, on ``device`` (the package
    default, ``cuda``, when None): the model's data and training and the
    rounds' wire and aggregation kernels all run there."""
    dev = _device.resolve(device)
    with _device.use_device(dev):
        fleet, cfg = configs(transport, n_clients=n_clients, model=model,
                             control=control, model_args=model_args)
        fleet_build = build_fleet_training(fleet, cfg)
    fleet_build.system.device = dev
    return fleet_build


def run_rounds(fleet_build: FleetBuild, rounds: int) -> list[dict]:
    """Run ``rounds`` sync rounds of a built arm.  Returns one record per
    round, the first (``round`` 0) being the model before them;
    ``wall_s`` is the host wall time of the round, ending after the
    device is idle."""
    system, objective = fleet_build.system, fleet_build.model

    def evaluate(params) -> dict:
        rec = {"loss": objective.loss(params)}
        if hasattr(objective, "accuracy"):
            rec["accuracy"] = objective.accuracy(params)
        return rec

    def idle() -> None:
        if system.device.type == "cuda":
            import torch
            torch.cuda.synchronize(system.device)

    records = [{"round": 0, "sim_ns": fleet_build.sim.now_ns,
                "cohorts": cohort_counts(fleet_build.profiles),
                **evaluate(system.global_params)}]
    for r in range(1, rounds + 1):
        t0 = time.perf_counter()
        res = system.run_round()
        idle()
        wall = time.perf_counter() - t0
        records.append({
            "round": r, "arrived": len(res.arrived),
            "failed": len(res.failed),
            "cut": len(set(res.roster) - set(res.arrived) - set(res.failed)),
            "late_folded": res.late_folded,
            "retransmissions": res.retransmissions,
            "packets_sent": res.packets_sent, "bytes_sent": res.bytes_sent,
            "decode_errors": res.decode_errors,
            "tiers": tier_counts(fleet_build),
            "renegotiations": sum(system.core.renegotiations.values()),
            "sim_ns": fleet_build.sim.now_ns, "wall_s": wall,
            **evaluate(system.global_params)})
    return records


def run(transport: str = "mudp+fec", *, rounds: int = ROUNDS,
        **build_kwargs) -> list[dict]:
    """:func:`build` one arm and :func:`run_rounds` it."""
    return run_rounds(build(transport, **build_kwargs), rounds)


def profile(trace_path: str, rounds: int = 3, **build_kwargs) -> dict:
    """Trace ``rounds`` rounds (after one untraced warm-up round) of one
    arm with ``torch.profiler`` on a CUDA device and write the chrome
    trace to ``trace_path``.  Returns the host wall time of the traced
    rounds, the device busy time, the idle share and device time by
    kernel (:func:`repro_torch.fl_mnist.trace_summary`)."""
    import torch
    from torch.profiler import ProfilerActivity

    from repro_torch.fl_mnist import trace_summary
    system = build(**build_kwargs).system
    if system.device.type != "cuda":
        raise RuntimeError("profile() measures a CUDA device")
    system.run_round()
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


def _print_arm(transport: str, model: str, records: list[dict]) -> None:
    head = records[0]
    print(f"\n=== {transport} / sync / star / {model}[python]: "
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
    if crossed is not None:
        print(f"--> sync time-to-target-loss ({TARGET_FRAC:.0%} of L0): "
              f"{crossed / 1e9:.2f} simulated seconds")
    else:
        print(f"--> sync: target loss not reached in {len(records) - 1} "
              f"rounds")
    if records[-1]["tiers"] is not None:
        print(f"    [adaptive] {records[-1]['renegotiations']} "
              f"renegotiations")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="consensus",
                    choices=["consensus", "mlp"],
                    help="what the clients train: the analytic consensus "
                         "objective or the MNIST MLP on non-IID shards")
    ap.add_argument("--control", default="static",
                    choices=["static", "adaptive"],
                    help="static runs mudp and udp; adaptive runs mudp+fec "
                         "and walks each client along the loss-driven "
                         "compression/FEC ladder")
    ap.add_argument("--clients", type=int, default=N_CLIENTS)
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--profile", metavar="TRACE_JSON", default=None,
                    help="trace --rounds rounds of the first arm on the "
                         "card with torch.profiler, write the chrome trace "
                         "here and print the device busy time and idle "
                         "share")
    ap.add_argument("--mode", default="sync",
                    choices=["sync", "async", "both"])
    ap.add_argument("--topology", default="star",
                    choices=["star", "hier", "gossip"])
    ap.add_argument("--train-backend", default="python",
                    choices=["python", "vmap", "shard"])
    args = ap.parse_args(argv)
    for flag, refused in _NOT_PORTED.items():
        value = getattr(args, flag)
        if value in refused:
            ap.error(f"--{flag.replace('_', '-')} {value}: "
                     f"{refused[value]} is not ported to repro_torch yet; "
                     f"this slice runs --mode sync --topology star "
                     f"--train-backend python")
    transports = (("mudp+fec",) if args.control == "adaptive"
                  else ("mudp", "udp"))
    kw = dict(n_clients=args.clients, model=args.model,
              control=args.control, device=args.device)
    if args.profile:
        print(json.dumps(profile(args.profile, args.rounds,
                                 transport=transports[0], **kw)))
        return
    for transport in transports:
        _print_arm(transport, args.model,
                   run(transport, rounds=args.rounds, **kw))


if __name__ == "__main__":
    main()
