"""Global-model quality across FL rounds under packet loss, on the port.

The counterpart of the reference's ``benchmarks/fl_convergence.py``
("maximizing the potential of the Global model in each round", paper
§I): the paper's MLP (784-32-10, ReLU; :mod:`repro_torch.models.mlp`) on
synthetic MNIST, two clients (10.1.2.10 and 10.1.2.11 on 100 Mb/s, 2 ms
links, ``BernoulliLoss(p, seed=i)`` uplinks, 3 full-batch SGD epochs a
round on ``sample(256, client=i + 1, step=round)``), 6 rounds of FedAvg
(the fedavg kernel at (2, 25450)), four arms: lossless ``mudp`` and
``mudp``, ``mudp+fec`` and ``udp`` at 10% uplink loss.  Accuracy is
taken on ``sample(1024, client=99, step=1)``.

Gates: each lossy ``mudp`` arm's accuracy equals the lossless arm's (the
protocol recovers every loss), and ``udp``'s is lower (zero-filled
gaps).  The round records equal the reference's (:data:`PINS`: they do
not depend on the weights' values) and each accuracy lies within
:data:`ACC_TOL` of the reference's.  The clients start from
:func:`repro_torch.models.mlp.init_paper_mlp` (the reference's
``jax.random.PRNGKey(0)`` weights, drawn in numpy to within 4 ULP)
unless ``global_params`` is given.

    PYTHONPATH=src python -m repro_torch.fl_convergence --device cpu
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
from typing import Any

from repro_torch import device as _device
from repro_torch.core.channel import BernoulliLoss, Link, NoLoss
from repro_torch.core.rounds import FederatedSystem, FLClient, FLConfig
from repro_torch.core.simulator import Simulator
from repro_torch.core.transport import TransportConfig
from repro_torch.data.mnist import SyntheticMnist
from repro_torch.models import mlp
from repro_torch.replay import round_record

SERVER = "10.1.2.5"
ROUNDS = 6
ARMS = (("lossless_mudp", "mudp", 0.0), ("lossy10_mudp", "mudp", 0.1),
        ("lossy10_mudp+fec", "mudp+fec", 0.1), ("lossy10_udp", "udp", 0.1))
#: each arm's accuracy against the reference's
ACC_TOL = 0.01


def run(transport: str, p_loss: float, rounds: int = ROUNDS, *,
        global_params: Any = None,
        device: _device.DeviceLike | None = None):
    """One arm: ``(accuracy, system)`` after ``rounds`` rounds."""
    dev = _device.resolve(device)
    ds = SyntheticMnist(seed=0)
    sim = Simulator()
    clients = []
    for i in range(2):
        addr = f"10.1.2.{10 + i}"
        lm = BernoulliLoss(p=p_loss, seed=i) if p_loss else NoLoss()
        sim.connect(addr, SERVER, Link(1e8, 2_000_000, lm),
                    Link(1e8, 2_000_000))
        clients.append(FLClient(addr, mlp.paper_train_fn(ds, i + 1, dev),
                                train_time_ns=500_000_000))
    cfg = FLConfig(aggregation="fedavg",
                   transport=TransportConfig(kind=transport,
                                             timeout_ns=1_000_000_000,
                                             udp_deadline_ns=2_000_000_000))
    if global_params is None:
        global_params = mlp.init_paper_mlp(0)
    system = FederatedSystem(sim, SERVER, clients, global_params, cfg,
                             device=dev)
    system.run_rounds(rounds)
    return (mlp.paper_accuracy(system.global_params, ds, step=1,
                               device=dev), system)


def measure(*, global_params: Any = None,
            device: _device.DeviceLike | None = None) -> dict[str, dict]:
    """Every arm: its accuracy, round records, final global parameters and
    wall time."""
    arms = {}
    for name, tr, p in ARMS:
        t0 = time.perf_counter()
        acc, system = run(tr, p, global_params=global_params, device=device)
        arms[name] = {"accuracy": acc,
                      "rounds": [round_record(r) for r in system.history],
                      "global_params": system.global_params,
                      "wall_us": (time.perf_counter() - t0) * 1e6}
    return arms


def bench():
    """``(row name, wall us, derived fields)``, as the reference's
    ``bench()``: the four arms' accuracy after six rounds."""
    return [(f"fl_convergence/{name}", arm["wall_us"],
             f"acc6rounds={arm['accuracy']:.3f}")
            for name, arm in measure().items()]


def digest(rounds: list[dict]) -> str:
    return hashlib.sha256(json.dumps(rounds, sort_keys=True).encode()
                          ).hexdigest()


def summary(rounds: list[dict]) -> dict:
    """The readable fields of a pin: totals over the rounds."""
    return {key: sum(len(r[key]) if isinstance(r[key], list) else r[key]
                     for r in rounds)
            for key in ("duration_ns", "arrived", "packets_sent",
                        "packets_dropped", "retransmissions")}


#: The reference's arms: its accuracy after 6 rounds, and the SHA-256 and
#: totals of its round records.
PINS = {
    "lossless_mudp": {
        "accuracy": 0.9921875,
        "sha256": "af34a836a232fb4336470c72dddbfd42"
                  "18fbb22cb49ca2f8b8b0492c097f9104",
        "summary": {"duration_ns": 3_136_232_160, "arrived": 12,
                    "packets_sent": 1704, "packets_dropped": 0,
                    "retransmissions": 0}},
    "lossy10_mudp": {
        "accuracy": 0.9921875,
        "sha256": "9e1b3529a674324cc6bfaa8556fe0053"
                  "9e4dc11daf0f7fcf88673ba460859d76",
        "summary": {"duration_ns": 9_160_049_200, "arrived": 12,
                    "packets_sent": 1907, "packets_dropped": 102,
                    "retransmissions": 103}},
    "lossy10_mudp+fec": {
        "accuracy": 0.9921875,
        "sha256": "4bf975abdcacdeee58aeafb48ae84e17"
                  "6634fa3520ef750257bedb3091df1e46",
        "summary": {"duration_ns": 10_131_788_160, "arrived": 12,
                    "packets_sent": 2057, "packets_dropped": 106,
                    "retransmissions": 65}},
    "lossy10_udp": {
        "accuracy": 0.763671875,
        "sha256": "f056061075fbcbfbc9619d0a037cb837"
                  "120c8976e15e77d5fb4a29eaf6c3fe8a",
        "summary": {"duration_ns": 5_115_983_920, "arrived": 12,
                    "packets_sent": 1680, "packets_dropped": 91,
                    "retransmissions": 0}},
}


def gate_failures(arms: dict[str, dict]) -> list[str]:
    """The benchmark's claims: lossy MUDP matches the lossless run, UDP
    degrades; each arm's rounds equal their pin and its accuracy lies
    within ACC_TOL of the reference's."""
    lossless = arms["lossless_mudp"]["accuracy"]
    failures = [f"{name}: accuracy {arms[name]['accuracy']} != lossless "
                f"{lossless}"
                for name in ("lossy10_mudp", "lossy10_mudp+fec")
                if arms[name]["accuracy"] != lossless]
    if not arms["lossy10_udp"]["accuracy"] < lossless:
        failures.append(f"lossy10_udp: accuracy "
                        f"{arms['lossy10_udp']['accuracy']} not below "
                        f"lossless {lossless}")
    for name, pin in PINS.items():
        arm = arms[name]
        got = {"sha256": digest(arm["rounds"]),
               "summary": summary(arm["rounds"])}
        if got != {k: pin[k] for k in got}:
            failures.append(f"{name}: rounds {got} != pinned {pin}")
        if abs(arm["accuracy"] - pin["accuracy"]) > ACC_TOL:
            failures.append(f"{name}: accuracy {arm['accuracy']} not "
                            f"within {ACC_TOL} of {pin['accuracy']}")
    return failures


def run_arms(*, global_params: Any = None,
             device: _device.DeviceLike | None = None
             ) -> tuple[dict[str, dict], list[str]]:
    """Every arm and the gates: ``(arms, failures)``."""
    arms = measure(global_params=global_params, device=device)
    return arms, gate_failures(arms)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    arms, failures = run_arms(device=_device.resolve(args.device))
    for name, arm in arms.items():
        print(f"fl_convergence/{name},{arm['wall_us']:.1f},"
              f"acc6rounds={arm['accuracy']:.3f}")
    for msg in failures:
        print(f"GATE FAILED: {msg}", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
