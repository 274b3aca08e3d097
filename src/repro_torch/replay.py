"""The pinned orchestrator replay: six deterministic FL scenarios, each over
every transport (``mudp``, ``udp``, ``tcp``, ``mudp+fec``).

Each scenario wires a small star by hand (linspace parameters, arithmetic
train functions, keyed splitmix64 link draws), runs a few sync rounds and
hashes every round record, the global model and the simulator stats into
one SHA-256 digest.  The reference pins these digests
(``tests/test_orchestrator_equivalence.py``); the port must reproduce
them bit for bit under both packet engines and both aggregation
backends, which holds only if the fedavg kernel is bit-identical to the
numpy fold.

* ``basic``    — 3 heterogeneous train fns, clean links, 2 rounds;
* ``lossy``    — Bernoulli and Gilbert-Elliott loss with per-packet jitter
  (retransmissions, NACK volleys, FEC repair, zero-filled UDP gaps);
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

#: The reference's pinned digests, by (scenario, transport).
EXPECTED: dict[tuple[str, str], str] = {
    ("basic", "mudp"):
        "89fb6e2b9edf5fe600538b45bd46e97f7ba4d8a495c41639de4857ec508a0645",
    ("lossy", "mudp"):
        "ce626ed312762297ea3ae48d965a2b1ac9bc3191fd6d41c3a91a78954cbcf59a",
    ("deadline", "mudp"):
        "74508036fd32fd10ebe66dbd10f3ca47a8ff6315e8f76e89f6f5c387f1f96fec",
    ("partial", "mudp"):
        "d3e2cc4914b80afa0d27fc5922baa0408c3692fb5b15c4f30f9634b5f01df53e",
    ("codec", "mudp"):
        "1216a1a977f05185bc59437bbaa76fd0824516fae11d4031e7a0a24708fb8068",
    ("failure", "mudp"):
        "362bf8ac844d8f80da997b17d0f308e5e9942891b6d212ab45fd6f059e43cfb5",
    ("basic", "udp"):
        "d5f0e0c624bbfab4d717c8bf5741607ad65547e11298a460deb9fdac80399624",
    ("lossy", "udp"):
        "fdd7d3197493395cf8afe45ea67f636224a55eca99f4d18cbe67a51d4274786e",
    ("deadline", "udp"):
        "3ff41d0b24d722881c2cc2b55bb84fcb3644b6bb402a6867f1cbdfb9e822d310",
    ("partial", "udp"):
        "73d2ccefc6a5a2eb9167902e32bc29bb04c69964603ada62b4d04bf17236c9c8",
    ("codec", "udp"):
        "a29e894de49e248aa9329a877745d3cbd342e33de335fac17156bfc9cc8052a1",
    ("failure", "udp"):
        "f3a82d5bcca04a3a2cad7e069d0c150c2cae4d6fd219e391d51393ab923eb615",
    ("basic", "tcp"):
        "85f45a84dcbd9994148adc32d544eaadd4d6d82f88bc78e7350278a98117ad4b",
    ("lossy", "tcp"):
        "54a38adf5b567a7bc4c2ed00aa315fba72a04a76ef699fec580a5116a396b0d1",
    ("deadline", "tcp"):
        "3b8fddb1777cc101ce1cc9a503d72f08d6d1e9045e0c835d78e1978d4d95464e",
    ("partial", "tcp"):
        "297a8a4669e84b7161c5c65eb9bcc99084597cb8a96021179f3ca5e6a01d81eb",
    ("codec", "tcp"):
        "615a63883ab4c11ce7ce761ac5fd76794fcc7c6392304b2b6448de31a7a5e21d",
    ("failure", "tcp"):
        "7e2520d085e7a61507e2de9fbf475fd293de6a393a3cbf42e1cabe447f91a9f5",
    ("basic", "mudp+fec"):
        "8fe3d920b5e83b2eaa777965b696d98042a649e2458c291ffc662bb7afdf04e0",
    ("lossy", "mudp+fec"):
        "081d2185673fa48eb2960c49f72f25bff3fb92e89ce6b167ff2cece330816c48",
    ("deadline", "mudp+fec"):
        "df5f0193035e8ccdfb86b544f4ad167f29c5cc2a9897b3d8ed3797920a9e21d7",
    ("partial", "mudp+fec"):
        "a0e28541021f3cb6d7a3162919decb880a35d90e8e2ae7bcac36fc230c628304",
    ("codec", "mudp+fec"):
        "04143c9931b554b1444ab79673f6b8ff86a96f0f44574f2ec8bea654a39669d2",
    ("failure", "mudp+fec"):
        "86793be1501a6f601cc9be8812aaa166f62cbb529e75aa42c65fcf168fe2678e",
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

#: the fields of a round that depend only on the simulation (not on the
#: parameters' values where the wire's sizes do not): the pinned set
#: without the clients' metrics, plus the decode errors
ROUND_FIELDS = tuple(f for f in _PINNED_FIELDS if f != "metrics") + (
    "decode_errors",)


def round_record(res) -> dict:
    """A :class:`RoundResult`'s :data:`ROUND_FIELDS` as a dict."""
    return {f: getattr(res, f) for f in ROUND_FIELDS}


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
