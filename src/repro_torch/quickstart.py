"""Quickstart on the port: the paper's experiment, end to end.

The counterpart of the reference's ``examples/quickstart.py`` (§V of "A
Modified UDP for Federated Learning Packet Transmissions"): a 3-node star
(clients 10.1.2.4 and 10.1.2.6, server 10.1.2.5) over 5 Mbps / 2000 ms
links.  Each client trains the paper's MLP (784-32-10, ReLU, from the
reference's ``jax.random.PRNGKey(0)`` weights drawn in numpy:
:func:`repro_torch.models.mlp.init_paper_mlp`) for 3 full-batch SGD
epochs at lr 0.1 on ``SyntheticMnist(seed=0).sample(256, client=id,
step=round)`` on the device; the weights are hex-encoded into packets
with (X, Np, A) headers, and the Modified UDP recovers packet 2 of client
one's update, dropped on its first transmission (test case 1).  The
server folds each arrival with paper Eq. 1 (``aggregation="pairwise"``),
on the host as the reference does, so this path launches no kernel.

:func:`run` returns the report and the failed asserts (both clients
arrive; accuracy on ``sample(1024, client=99, step=0)`` improves) and
holds the round record and the printed trace lines against
:data:`PIN`, the reference's.  Those depend only on the parameter count:
the hex body's length is fixed by it.

    PYTHONPATH=src python -m repro_torch.quickstart --device cpu
"""

from __future__ import annotations

import argparse
import sys
from typing import Any

from repro_torch import device as _device
from repro_torch.core.channel import DropList, Link, NoLoss
from repro_torch.core.rounds import FederatedSystem, FLClient, FLConfig
from repro_torch.core.simulator import Simulator
from repro_torch.core.transport import TransportConfig
from repro_torch.data.mnist import SyntheticMnist
from repro_torch.models import mlp
from repro_torch.paper_cases import CLIENT as CLIENT1
from repro_torch.paper_cases import CLIENT2, PAPER_DELAY, PAPER_RATE, SERVER
from repro_torch.replay import round_record

SHOWN = ("missing", "NACK", "DROP", "(0, 0,")

#: The reference's round record and printed trace lines.
PIN = {
    "round": {"round_idx": 0, "duration_ns": 9_336_521_600,
              "arrived": [CLIENT1, CLIENT2], "failed": [],
              "skipped_unhealthy": [], "late_folded": 0,
              "bytes_sent": 419_106, "packets_sent": 282,
              "packets_dropped": 1, "retransmissions": 1,
              "roster": [CLIENT1, CLIENT2], "data_packets": 279,
              "nack_packets": 1, "parity_packets": 0, "decode_errors": 0},
    "trace": [
        "t=1000000000ns DROP  10.1.2.4->10.1.2.5 (2, 139, 10.1.2.4)",
        "t=3333988800ns 10.1.2.5: packet 2 is missing! requesting resend",
        "t=3333988800ns SEND  10.1.2.5->10.1.2.6 (0, 0, 10.1.2.5) arrives "
        "t=5334048000ns",
        "t=5334048000ns 10.1.2.4: NACK for missing packet 2, resending",
        "t=7336462400ns SEND  10.1.2.5->10.1.2.4 (0, 0, 10.1.2.5) arrives "
        "t=9336521600ns"],
}


def shown_trace(lines: list[str]) -> list[str]:
    """The trace lines the example prints (paper Figs 5/7)."""
    shown = []
    for line in lines:
        if any(s in line for s in SHOWN):
            shown.append(line)
        if len(shown) > 14:
            break
    return shown


def run(*, global_params: Any = None,
        device: _device.DeviceLike | None = None) -> tuple[dict, list[str]]:
    """One round from ``global_params`` (default:
    :func:`mlp.init_paper_mlp`): ``(report, failures)``.  The report holds
    the accuracy before and after, the round record, the shown trace
    lines and the new global parameters."""
    dev = _device.resolve(device)
    dataset = SyntheticMnist(seed=0)
    sim = Simulator(trace=True)
    sim.connect(CLIENT1, SERVER,
                Link(PAPER_RATE, PAPER_DELAY, DropList({(2, 0)})),
                Link(PAPER_RATE, PAPER_DELAY))
    sim.connect(CLIENT2, SERVER, Link(PAPER_RATE, PAPER_DELAY, NoLoss()),
                Link(PAPER_RATE, PAPER_DELAY))
    if global_params is None:
        global_params = mlp.init_paper_mlp(0)
    clients = [FLClient(addr, mlp.paper_train_fn(dataset, cid, dev),
                        train_time_ns=1_000_000_000)
               for cid, addr in ((1, CLIENT1), (2, CLIENT2))]
    cfg = FLConfig(
        aggregation="pairwise",                      # paper Eq. (1)
        transport=TransportConfig(kind="mudp", codec="hex",  # Algorithm I
                                  timeout_ns=6_000_000_000, max_retries=3),
        broadcast_model=False)                       # round 0: clients seeded
    system = FederatedSystem(sim, SERVER, clients, global_params, cfg,
                             device=dev)
    for c in clients:
        c.params = global_params
    acc0 = mlp.paper_accuracy(system.global_params, dataset, step=0,
                              device=dev)
    res = system.run_round()
    acc1 = mlp.paper_accuracy(system.global_params, dataset, step=0,
                              device=dev)
    report = {"acc0": acc0, "acc1": acc1, "round": round_record(res),
              "trace": shown_trace(sim.trace_lines),
              "global_params": system.global_params}
    failures = []
    if sorted(res.arrived) != [CLIENT1, CLIENT2]:
        failures.append(f"recovery failed: arrived {res.arrived}")
    if not acc1 > acc0:
        failures.append(f"global model did not improve: {acc0} -> {acc1}")
    for key in ("round", "trace"):
        if report[key] != PIN[key]:
            failures.append(f"{key} {report[key]} != pinned {PIN[key]}")
    return report, failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    print("=== Modified UDP for FL: paper quickstart ===")
    report, failures = run(device=args.device)
    rec = report["round"]
    print(f"global model accuracy before round: {report['acc0']:.3f}")
    print(f"\nround 0 complete at t={rec['duration_ns'] / 1e9:.2f}s "
          f"(sim time)")
    print(f"  arrived: {rec['arrived']}   failed: {rec['failed']}")
    print(f"  packets sent={rec['packets_sent']} "
          f"dropped={rec['packets_dropped']} "
          f"retransmissions={rec['retransmissions']}")
    print(f"global model accuracy after round:  {report['acc1']:.3f}")
    print("\n--- transport trace (paper Figs 5/7 equivalent) ---")
    for line in report["trace"]:
        print(" ", line)
    for msg in failures:
        print(f"GATE FAILED: {msg}", file=sys.stderr)
    if failures:
        return 1
    print("\nOK: lost packet recovered, both clients aggregated, "
          "global model improved.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
