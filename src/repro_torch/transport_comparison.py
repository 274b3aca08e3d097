"""Every registered transport on the paper's topology, swept over loss
rates, on the port.

The counterpart of the reference's ``benchmarks/transport_comparison.py``
(the paper's future-work comparison): ``--rounds`` FL rounds of a
40,000-parameter ``{"w"}`` model whose two clients (10.1.2.10 and
10.1.2.11, 100 Mb/s, 5 ms, ``BernoulliLoss(p, seed=i)`` uplinks) return
constant updates, at loss rates 0, 0.05, 0.1 and 0.2 for each transport
in ``available_transports()``.  Each row gives the simulated time summed
over the rounds, the arrivals, the retransmissions and the L2 distance of
the global model from the lossless ``mudp`` run's.  The server folds the
two uplinks with FedAvg on the device: the fedavg kernel at (2, 40000).

Every field but the wall time equals the reference's row at
``--rounds 1`` (:data:`PINS`): the loss draws are keyed host numpy and
the kernel's fold is the numpy fold's, bit for bit.

    PYTHONPATH=src python -m repro_torch.transport_comparison --device cpu
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from repro_torch import device as _device
from repro_torch.core.channel import BernoulliLoss, Link
from repro_torch.core.packetizer import flatten_to_vector
from repro_torch.core.rounds import FederatedSystem, FLClient, FLConfig
from repro_torch.core.simulator import Simulator
from repro_torch.core.transport import TransportConfig, available_transports
from repro_torch.transport_scenarios import pin_failures

SERVER = "10.1.2.5"
LOSS_RATES = (0.0, 0.05, 0.1, 0.2)
N_PARAMS = 40_000


def _const_train(value):
    def fn(params, round_idx, client):
        return {k: np.full_like(v, value) for k, v in params.items()}, {}
    return fn


def run(transport: str, p_loss: float, seed: int = 0, rounds: int = 1,
        device: _device.DeviceLike | None = None):
    """One (transport, loss rate) configuration: its system after
    ``rounds`` rounds and the rounds' results."""
    sim = Simulator()
    params = {"w": np.zeros((N_PARAMS,), np.float32)}
    clients = []
    for i in range(2):
        addr = f"10.1.2.{10 + i}"
        sim.connect(addr, SERVER,
                    Link(1e8, 5_000_000, BernoulliLoss(p=p_loss,
                                                       seed=seed + i)),
                    Link(1e8, 5_000_000))
        clients.append(FLClient(addr, _const_train(float(i + 1)),
                                train_time_ns=1_000_000))
    cfg = FLConfig(aggregation="fedavg", broadcast_model=False,
                   transport=TransportConfig(kind=transport,
                                             timeout_ns=2_000_000_000,
                                             udp_deadline_ns=3_000_000_000))
    system = FederatedSystem(sim, SERVER, clients, params, cfg,
                             device=device)
    for c in clients:
        c.params = params
    results = [system.run_round() for _ in range(rounds)]
    return system, results


def measure(rounds: int = 1, device: _device.DeviceLike | None = None
            ) -> dict[str, dict]:
    """Every row's fields at full precision, by row name."""
    clean, _ = run("mudp", 0.0, rounds=rounds, device=device)
    target = flatten_to_vector(clean.global_params)
    rows = {}
    for p in LOSS_RATES:
        for tr in available_transports():
            t0 = time.perf_counter()
            system, results = run(tr, p, rounds=rounds, device=device)
            wall_us = (time.perf_counter() - t0) * 1e6
            rows[f"transport_comparison/{tr}_p{p:g}"] = {
                "wall_us": wall_us,
                "sim_ns": sum(r.duration_ns for r in results),
                "arrivals": sum(len(r.arrived) for r in results),
                "of": 2 * len(results),
                "retx": sum(r.retransmissions for r in results),
                "l2err": float(np.linalg.norm(
                    flatten_to_vector(system.global_params) - target))}
    return rows


def derived(row: dict) -> str:
    """A row's fields as the reference prints them."""
    return (f"sim_s={row['sim_ns'] / 1e9:.3f}"
            f";arrivals={row['arrivals']}/{row['of']}"
            f";retx={row['retx']};l2err={row['l2err']:.3f}")


def bench(rounds: int = 1, device: _device.DeviceLike | None = None):
    """``(row name, wall us, derived fields)``, as the reference's
    ``bench()``."""
    return [(name, row["wall_us"], derived(row))
            for name, row in measure(rounds, device).items()]


def run_sweep(rounds: int = 1, device: _device.DeviceLike | None = None
              ) -> tuple[list, list[str]]:
    """``(rows, failures)``: at one round (the reference's pinned runs)
    every row held against :data:`PINS`."""
    rows = bench(rounds, device)
    return rows, pin_failures(rows, PINS) if rounds == 1 else []


#: The reference's derived fields at ``--rounds 1``, by row.
PINS = {f"transport_comparison/{name}": fields for name, fields in (
    ("mudp_p0", "sim_s=0.024;arrivals=2/2;retx=0;l2err=0.000"),
    ("mudp+fec_p0", "sim_s=0.024;arrivals=2/2;retx=0;l2err=0.000"),
    ("tcp_p0", "sim_s=0.092;arrivals=2/2;retx=0;l2err=0.000"),
    ("udp_p0", "sim_s=0.019;arrivals=2/2;retx=0;l2err=0.000"),
    ("mudp_p0.05", "sim_s=0.035;arrivals=2/2;retx=9;l2err=0.000"),
    ("mudp+fec_p0.05", "sim_s=2.021;arrivals=2/2;retx=6;l2err=0.000"),
    ("tcp_p0.05", "sim_s=2.251;arrivals=2/2;retx=20;l2err=0.000"),
    ("udp_p0.05", "sim_s=0.019;arrivals=2/2;retx=0;l2err=43.955"),
    ("mudp_p0.1", "sim_s=2.034;arrivals=2/2;retx=22;l2err=0.000"),
    ("mudp+fec_p0.1", "sim_s=2.021;arrivals=2/2;retx=13;l2err=0.000"),
    ("tcp_p0.1", "sim_s=18.392;arrivals=2/2;retx=24;l2err=0.000"),
    ("udp_p0.1", "sim_s=0.019;arrivals=2/2;retx=0;l2err=72.415"),
    ("mudp_p0.2", "sim_s=4.034;arrivals=2/2;retx=54;l2err=0.000"),
    ("mudp+fec_p0.2", "sim_s=4.021;arrivals=2/2;retx=46;l2err=0.000"),
    ("tcp_p0.2", "sim_s=62.574;arrivals=2/2;retx=55;l2err=0.000"),
    ("udp_p0.2", "sim_s=0.019;arrivals=2/2;retx=0;l2err=117.473"))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=1,
                    help="FL rounds per (transport, loss) configuration")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    if args.rounds < 1:
        ap.error("--rounds must be >= 1")
    rows, failures = run_sweep(args.rounds, _device.resolve(args.device))
    for name, us, fields in rows:
        print(f"{name},{us:.1f},{fields}")
    for msg in failures:
        print(f"GATE FAILED: {msg}", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
