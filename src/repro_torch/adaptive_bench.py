"""Adaptive transport control against every static wire/FEC tier, on the
port: simulated time to a target loss on the mixed fiber / lte /
congested-edge cohort.

The counterpart of the reference's ``benchmarks/adaptive_bench.py``: the
same seeded fleet (``--clients`` 32, the consensus objective at
``--params`` 2048, a 20 s round deadline, the ``batched`` engine,
``mudp+fec`` with an ``int8(1024)`` downlink) runs once with each tier of
:data:`repro_torch.core.control.DEFAULT_TIERS` pinned fleet-wide
(``static/tier0-2``) and once under ``control="adaptive"``, which starts
every client on the middle rung and walks each by its loss-rate EWMA.
Each arm runs up to ``--max-rounds`` 16 rounds; the report gives the
rounds and simulated time to 2% of the initial loss, the final loss and
the renegotiations by cohort.  The device does the array work: the
``topk`` and ``int8`` wire stages (the top-k gather and scatter,
quantize, dequantize) and the server's delta-domain FedAvg (fedavg).

``--check`` holds two gates and exits 1 if either fails:

1. adaptive reaches the target in strictly less simulated time than
   every static arm;
2. ``control="static"`` leaves every pinned orchestrator digest
   (:data:`repro_torch.replay.EXPECTED`, 24 of them) byte-identical under
   both packet engines.

The consensus fleets are bitwise on the port, so at the default
arguments every arm also equals the reference's (:data:`PINS`); ``--check``
holds that too.

    PYTHONPATH=src python -m repro_torch.adaptive_bench --device cpu --check
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time

from repro_torch import device as _device
from repro_torch import replay
from repro_torch.core.control import DEFAULT_TIERS
from repro_torch.core.fleet import FleetConfig, build_fleet_training
from repro_torch.core.rounds import FLConfig
from repro_torch.core.simulator import PACKET_ENGINES
from repro_torch.core.transport import TransportConfig

NS = 1_000_000_000

#: The static arms: each ladder tier, pinned fleet-wide.
STATIC_ARMS = {f"static/tier{i}": t for i, t in enumerate(DEFAULT_TIERS)}
DEFAULTS = {"clients": 32, "seed": 0, "target_frac": 0.02, "params": 2048,
            "max_rounds": 16, "deadline_s": 20.0, "engine": "batched"}


def _fl_cfg(*, uplink: str, fec_block: int, fec_parity: int) -> FLConfig:
    return FLConfig(
        aggregation="fedavg",
        transport=TransportConfig(
            kind="mudp+fec", uplink=uplink, downlink="int8(1024)",
            fec_block=fec_block, fec_parity=fec_parity,
            timeout_ns=2 * NS, udp_deadline_ns=3 * NS))


def time_to_target(arm: str, *, n_clients: int, seed: int, target_frac: float,
                   n_params: int, max_rounds: int, deadline_ns: int,
                   engine: str) -> dict:
    """Run one arm until the loss target is crossed (or max_rounds)."""
    if arm == "adaptive":
        control, tier = "adaptive", DEFAULT_TIERS[1]   # the starting rung
    else:
        control, tier = "static", STATIC_ARMS[arm]
    fleet = FleetConfig(n_clients=n_clients, seed=seed, engine=engine,
                        model="consensus",
                        model_args={"n_params": n_params},
                        round_deadline_ns=deadline_ns, control=control)
    build = build_fleet_training(
        fleet, _fl_cfg(uplink=tier["uplink"], fec_block=tier["fec_block"],
                       fec_parity=tier["fec_parity"]))
    sim, system, model = build.sim, build.system, build.model
    loss0 = model.loss(system.global_params)
    target = target_frac * loss0
    trace: list[dict] = []

    def on_round(res, params):
        trace.append({"round": res.round_idx, "sim_ns": sim.now_ns,
                      "loss": model.loss(params),
                      "arrived": len(res.arrived),
                      "decode_errors": res.decode_errors})
    system.on_round_end = on_round
    t0 = time.perf_counter()
    system.run_rounds(max_rounds)
    wall_s = time.perf_counter() - t0

    crossed = next((row for row in trace if row["loss"] <= target), None)
    core = system.core
    reneg_by_cohort: dict[str, int] = {}
    for p in build.profiles:
        reneg_by_cohort[p.cohort] = (reneg_by_cohort.get(p.cohort, 0)
                                     + core.renegotiations.get(p.addr, 0))
    return {
        "arm": arm,
        "initial_loss": loss0,
        "target_loss": target,
        "rounds_run": len(trace),
        "rounds_to_target": crossed["round"] + 1 if crossed else None,
        "sim_ns_to_target": crossed["sim_ns"] if crossed else None,
        "final_loss": trace[-1]["loss"] if trace else loss0,
        "renegotiations": sum(core.renegotiations.values()),
        "renegotiations_by_cohort": dict(sorted(reneg_by_cohort.items())),
        "decode_errors": sum(r["decode_errors"] for r in trace),
        "trace": trace,
        "wall_s": wall_s,
    }


def compare(**args) -> dict:
    """Every arm at ``args`` (:data:`DEFAULTS` for any not given)."""
    a = dict(DEFAULTS, **args)
    kw = dict(n_clients=a["clients"], seed=a["seed"],
              target_frac=a["target_frac"], n_params=a["params"],
              max_rounds=a["max_rounds"],
              deadline_ns=int(a["deadline_s"] * NS), engine=a["engine"])
    arms = {name: time_to_target(name, **kw)
            for name in (*STATIC_ARMS, "adaptive")}
    adaptive_ns = arms["adaptive"]["sim_ns_to_target"]
    beats_all = adaptive_ns is not None and all(
        cell["sim_ns_to_target"] is None
        or adaptive_ns < cell["sim_ns_to_target"]
        for name, cell in arms.items() if name != "adaptive")
    return {"meta": a, "arms": arms, "adaptive_beats_every_static": beats_all}


def bench():
    """``(row name, wall us, derived fields)``, as the reference's
    ``bench()``: one small comparison cell."""
    report = compare(clients=24, seed=0, target_frac=0.02, params=1024,
                     max_rounds=12, deadline_s=20.0, engine="batched")
    rows = []
    for name, cell in report["arms"].items():
        rows.append((f"adaptive/{name.replace('/', '_')}_c24",
                     cell["wall_s"] * 1e6,
                     f"sim_s_to_target="
                     f"{(cell['sim_ns_to_target'] or 0) / 1e9:.2f}"
                     f";rounds={cell['rounds_to_target']}"
                     f";reneg={cell['renegotiations']}"
                     f";final_loss={cell['final_loss']:.4f}"))
    rows.append(("adaptive/beats_every_static", 0.0,
                 str(report["adaptive_beats_every_static"])))
    return rows


def digests_frozen_under_static() -> list[str]:
    """The pinned orchestrator replays with ``control="static"`` set, under
    both packet engines; returns the mismatches (empty: the control plane
    does not perturb the default path)."""
    mismatches = []
    for (scenario, kind), want in sorted(replay.EXPECTED.items()):
        for engine in PACKET_ENGINES:
            got = replay.run_digest(scenario, kind, engine, control="static")
            if got != want:
                mismatches.append(f"{scenario}/{kind}/{engine}: "
                                  f"{got} != pinned {want}")
    return mismatches


def arm_view(cell: dict) -> dict:
    """An arm's simulated fields (everything but its wall time), with its
    trace as a SHA-256."""
    view = {k: v for k, v in cell.items() if k not in ("trace", "wall_s")}
    view["trace_sha256"] = hashlib.sha256(
        json.dumps(cell["trace"], sort_keys=True).encode()).hexdigest()
    return view


#: The reference's arms at :data:`DEFAULTS` (:func:`arm_view`).
PINS = {
    "static/tier0": {
        "arm": "static/tier0",
        "decode_errors": 0,
        "final_loss": 0.00012387237802613527,
        "initial_loss": 1.0040700435638428,
        "renegotiations": 0,
        "renegotiations_by_cohort": {"congested-edge": 0, "fiber": 0, "lte": 0},
        "rounds_run": 16,
        "rounds_to_target": 4,
        "sim_ns_to_target": 27742145109,
        "target_loss": 0.020081400871276855,
        "trace_sha256": "e4d027f314ccd89e0741f528279cdb13"
                        "6ff3d959581be49ee42a423864fb3afc",
    },
    "static/tier1": {
        "arm": "static/tier1",
        "decode_errors": 0,
        "final_loss": 0.00044164463179185987,
        "initial_loss": 1.0040700435638428,
        "renegotiations": 0,
        "renegotiations_by_cohort": {"congested-edge": 0, "fiber": 0, "lte": 0},
        "rounds_run": 16,
        "rounds_to_target": 9,
        "sim_ns_to_target": 50891890708,
        "target_loss": 0.020081400871276855,
        "trace_sha256": "34d6f3cbdda14b449e4253a52a2a1560"
                        "6b29ef4616bff90f981d71e0a8454db7",
    },
    "static/tier2": {
        "arm": "static/tier2",
        "decode_errors": 0,
        "final_loss": 0.12826381623744965,
        "initial_loss": 1.0040700435638428,
        "renegotiations": 0,
        "renegotiations_by_cohort": {"congested-edge": 0, "fiber": 0, "lte": 0},
        "rounds_run": 16,
        "rounds_to_target": None,
        "sim_ns_to_target": None,
        "target_loss": 0.020081400871276855,
        "trace_sha256": "15d0b0178fd7bf90ddb0f404d75bba74"
                        "2ce2814d798a0dd5a958017f5c04739d",
    },
    "adaptive": {
        "arm": "adaptive",
        "decode_errors": 0,
        "final_loss": 0.0004087075940333307,
        "initial_loss": 1.0040700435638428,
        "renegotiations": 109,
        "renegotiations_by_cohort": {"congested-edge": 41, "fiber": 10, "lte": 58},
        "rounds_run": 16,
        "rounds_to_target": 3,
        "sim_ns_to_target": 20102936646,
        "target_loss": 0.020081400871276855,
        "trace_sha256": "cb533178ab578048816b9bb572944002"
                        "e7459239816131cc85ff0cbded6a928b",
    },
}


def check(report: dict) -> list[str]:
    """Both gates, and each arm against its pin at the default
    arguments."""
    failures = []
    if not report["adaptive_beats_every_static"]:
        failures.append("a static arm matched or beat adaptive "
                        "time-to-target")
    failures += [f"control='static' perturbed a pinned digest: {m}"
                 for m in digests_frozen_under_static()]
    if report["meta"] == DEFAULTS:
        for name, pin in PINS.items():
            got = arm_view(report["arms"][name])
            if got != pin:
                failures.append(f"{name}: {got} != pinned {pin}")
    return failures


def run_check(**args) -> tuple[dict, list[str]]:
    """Every arm (:func:`compare`) and :func:`check`:
    ``(report, failures)``."""
    report = compare(**args)
    return report, check(report)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clients", type=int, default=DEFAULTS["clients"])
    ap.add_argument("--seed", type=int, default=DEFAULTS["seed"])
    ap.add_argument("--target-frac", type=float,
                    default=DEFAULTS["target_frac"],
                    help="target loss as a fraction of the initial loss")
    ap.add_argument("--params", type=int, default=DEFAULTS["params"])
    ap.add_argument("--max-rounds", type=int, default=DEFAULTS["max_rounds"])
    ap.add_argument("--deadline-s", type=float,
                    default=DEFAULTS["deadline_s"],
                    help="sync round deadline (straggler cutoff)")
    ap.add_argument("--engine", default=DEFAULTS["engine"],
                    choices=list(PACKET_ENGINES))
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--out", default=None, help="optional JSON report path")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 unless adaptive reaches the target in "
                         "strictly less simulated time than every static "
                         "arm and control='static' leaves every pinned "
                         "orchestrator digest byte-identical")
    args = ap.parse_args(argv)
    arm_args = {k: getattr(args, k) for k in DEFAULTS}
    with _device.use_device(_device.resolve(args.device)):
        report, failures = (run_check(**arm_args) if args.check
                            else (compare(**arm_args), []))
    for name, cell in report["arms"].items():
        sim_s = (cell["sim_ns_to_target"] or 0) / 1e9
        crossed = cell["rounds_to_target"] is not None
        print(f"{name:>13}: L0={cell['initial_loss']:.3f} -> target "
              f"{cell['target_loss']:.4f} "
              + (f"in {cell['rounds_to_target']} rounds, "
                 f"sim t={sim_s:.2f}s" if crossed else
                 f"NOT REACHED (final {cell['final_loss']:.4f})")
              + f", reneg={cell['renegotiations']} "
              f"{cell['renegotiations_by_cohort']}")
    print("adaptive beats every static arm:"
          f" {report['adaptive_beats_every_static']}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1, sort_keys=True)
        print(f"wrote {args.out}")
    for msg in failures:
        print(f"CHECK FAILED: {msg}", file=sys.stderr)
    if args.check and not failures:
        print("check passed: adaptive < every static arm; control='static' "
              "leaves all pinned digests byte-identical")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
