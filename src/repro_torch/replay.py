"""The pinned orchestrator replay: six deterministic FL scenarios over mudp.

Each scenario wires a small star by hand (linspace parameters, arithmetic
train functions, keyed splitmix64 link draws), runs a few sync rounds and
hashes every round record, the global model and the simulator stats into
one SHA-256 digest.  The reference pins these digests
(``tests/test_orchestrator_equivalence.py``, transport ``mudp``); the
port must reproduce them bit for bit under both packet engines and both
aggregation backends, which holds only if the fedavg kernel is
bit-identical to the numpy fold.

* ``basic``    — 3 heterogeneous train fns, clean links, 2 rounds;
* ``lossy``    — Bernoulli and Gilbert-Elliott loss with per-packet jitter;
* ``deadline`` — a 5 s straggler against a 2 s round deadline;
* ``partial``  — 6 clients at participation_fraction=0.5;
* ``codec``    — pairwise Eq.-1 aggregation, delta shipping with
  error-feedback int8;
* ``failure``  — a dead uplink driving retry exhaustion and re-admission.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

from repro_torch import device as _device
from repro_torch.core.channel import (BernoulliLoss, DropList, GilbertElliott,
                                      Link, NoLoss)
from repro_torch.core.rounds import FederatedSystem, FLClient, FLConfig
from repro_torch.core.simulator import Simulator
from repro_torch.core.transport import TransportConfig

SERVER = "10.1.2.5"
NS = 1_000_000_000

#: The reference's pinned digests for transport ``mudp``.
EXPECTED_MUDP: dict[str, str] = {
    "basic":
        "89fb6e2b9edf5fe600538b45bd46e97f7ba4d8a495c41639de4857ec508a0645",
    "lossy":
        "ce626ed312762297ea3ae48d965a2b1ac9bc3191fd6d41c3a91a78954cbcf59a",
    "deadline":
        "74508036fd32fd10ebe66dbd10f3ca47a8ff6315e8f76e89f6f5c387f1f96fec",
    "partial":
        "d3e2cc4914b80afa0d27fc5922baa0408c3692fb5b15c4f30f9634b5f01df53e",
    "codec":
        "1216a1a977f05185bc59437bbaa76fd0824516fae11d4031e7a0a24708fb8068",
    "failure":
        "362bf8ac844d8f80da997b17d0f308e5e9942891b6d212ab45fd6f059e43cfb5",
}


def make_params(n: int = 301):
    return {"w": np.linspace(-1.0, 1.0, n, dtype=np.float32),
            "b": np.zeros((7,), dtype=np.float32)}


def add_train_fn(delta):
    def fn(params, round_idx, client):
        return ({k: v + np.float32(delta) for k, v in params.items()},
                {"loss": 0.0})
    return fn


def const_train_fn(value):
    def fn(params, round_idx, client):
        return ({k: np.full_like(v, value) for k, v in params.items()}, {})
    return fn


def _connect(sim, addr, *, loss=None, jitter_ns=0, seed=0):
    up = Link(1e8, 1_000_000, loss or NoLoss(),
              jitter_ns=jitter_ns, jitter_seed=seed)
    down = Link(1e8, 1_000_000, NoLoss(),
                jitter_ns=jitter_ns, jitter_seed=seed + 1)
    sim.connect(addr, SERVER, up, down)


def _basic(sim, kind):
    clients = []
    for i in range(3):
        addr = f"10.1.2.{10 + i}"
        _connect(sim, addr)
        fn = const_train_fn(2.0) if i == 2 else add_train_fn(0.1 * (i + 1))
        clients.append(FLClient(addr, fn, train_time_ns=1_000_000 * (i + 1)))
    cfg = FLConfig(aggregation="fedavg",
                   transport=TransportConfig(kind=kind, timeout_ns=NS))
    return clients, cfg, 2


def _lossy(sim, kind):
    clients = []
    for i in range(3):
        addr = f"10.1.2.{10 + i}"
        loss = (GilbertElliott(p_good_loss=0.02, p_bad_loss=0.5,
                               p_bad=0.1, seed=40 + i) if i == 2
                else BernoulliLoss(p=0.15, seed=30 + i))
        _connect(sim, addr, loss=loss, jitter_ns=500_000, seed=7 * i)
        clients.append(FLClient(addr, add_train_fn(0.5),
                                train_time_ns=2_000_000))
    cfg = FLConfig(aggregation="fedavg",
                   transport=TransportConfig(kind=kind, timeout_ns=NS,
                                             udp_deadline_ns=2 * NS))
    return clients, cfg, 2


def _deadline(sim, kind):
    clients = []
    for i, tt in enumerate((1_000_000, 5 * NS)):
        addr = f"10.1.2.{10 + i}"
        _connect(sim, addr)
        clients.append(FLClient(addr, const_train_fn(float(i + 1)),
                                train_time_ns=tt))
    cfg = FLConfig(aggregation="fedavg", round_deadline_ns=2 * NS,
                   staleness_discount=0.5,
                   transport=TransportConfig(kind=kind, timeout_ns=NS))
    return clients, cfg, 2


def _partial(sim, kind):
    clients = []
    for i in range(6):
        addr = f"10.1.2.{10 + i}"
        _connect(sim, addr)
        clients.append(FLClient(addr, add_train_fn(0.25),
                                train_time_ns=1_000_000 + 250_000 * i))
        clients[-1].weight = 1.0 + 0.5 * i
    cfg = FLConfig(aggregation="fedavg", participation_fraction=0.5,
                   participation_seed=13,
                   transport=TransportConfig(kind=kind, timeout_ns=NS))
    return clients, cfg, 2


def _codec(sim, kind):
    clients = []
    for i in range(2):
        addr = f"10.1.2.{10 + i}"
        _connect(sim, addr)
        clients.append(FLClient(addr, add_train_fn(0.3 * (i + 1)),
                                train_time_ns=1_000_000))
    cfg = FLConfig(aggregation="pairwise", send_deltas=True,
                   error_feedback=True,
                   transport=TransportConfig(kind=kind, codec="int8",
                                             timeout_ns=NS,
                                             udp_deadline_ns=2 * NS))
    return clients, cfg, 2


def _failure(sim, kind):
    dead = {(s, a) for s in range(1, 4000) for a in range(0, 60)}
    clients = []
    for i in range(2):
        addr = f"10.1.2.{10 + i}"
        _connect(sim, addr, loss=DropList(dead) if i == 1 else None)
        clients.append(FLClient(addr, const_train_fn(float(i + 1)),
                                train_time_ns=1_000_000))
    cfg = FLConfig(aggregation="fedavg", unhealthy_after_failures=1,
                   readmit_after_rounds=2,
                   transport=TransportConfig(kind=kind,
                                             timeout_ns=500_000_000,
                                             udp_deadline_ns=NS))
    return clients, cfg, 3


SCENARIOS = {
    "basic": _basic,
    "lossy": _lossy,
    "deadline": _deadline,
    "partial": _partial,
    "codec": _codec,
    "failure": _failure,
}

# RoundResult fields the digest covers (the reference's pinned set).
_PINNED_FIELDS = ("round_idx", "duration_ns", "arrived", "failed",
                  "skipped_unhealthy", "late_folded", "bytes_sent",
                  "packets_sent", "packets_dropped", "retransmissions",
                  "metrics", "roster", "data_packets", "nack_packets",
                  "parity_packets")


def run_digest(scenario: str, kind: str = "mudp",
               engine: str = "per_packet",
               device: _device.DeviceLike | None = None,
               **cfg_extra) -> str:
    """Run one scenario and return its SHA-256 digest; ``cfg_extra``
    overrides :class:`FLConfig` fields (e.g. ``aggregation_backend``)."""
    sim = Simulator(engine=engine)
    clients, cfg, rounds = SCENARIOS[scenario](sim, kind)
    if cfg_extra:
        cfg = dataclasses.replace(cfg, **cfg_extra)
    system = FederatedSystem(sim, SERVER, clients, make_params(), cfg,
                             device=device)
    h = hashlib.sha256()
    for _ in range(rounds):
        res = system.run_round()
        row = {f: getattr(res, f) for f in _PINNED_FIELDS}
        h.update(repr(sorted(row.items())).encode())
    for key in sorted(system.global_params):
        leaf = np.ascontiguousarray(system.global_params[key], dtype="<f4")
        h.update(key.encode())
        h.update(leaf.tobytes())
    h.update(sim.stats_digest().encode())
    return h.hexdigest()
