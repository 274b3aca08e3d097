"""Flow-engine scenarios run through either package.

``tests/statcheck.py`` builds its single-link and fleet scenarios from the
reference (``repro.core``).  The functions here build the same scenarios
from whichever package is passed (``repro.core`` or ``repro_torch.core``:
the two export the same names), so one scenario can be run through both
and compared bit for bit, and the port's flow engine can be swept against
the port's batched engine through statcheck's unchanged ``sweep`` /
``compare_sweeps``.
"""

from __future__ import annotations

import dataclasses
import importlib

import numpy as np

NS = 1_000_000_000


def core(pkg: str):
    """``repro.core`` or ``repro_torch.core`` by package name."""
    return importlib.import_module(f"{pkg}.core")


def flow_module(pkg: str):
    return importlib.import_module(f"{pkg}.core.flow")


def transfer(pkg: str, engine: str, kind: str, seed: int, *,
             loss_p: float = 0.1, bursty: bool = False,
             payload: int = 60_000, mtu: int = 1200,
             rate_bps: float = 1e7, delay_ns: int = 5_000_000,
             jitter_ns: int = 0, timeout_ns: int = 2 * NS,
             max_retries: int | None = None, **cfg_kw) -> dict:
    """statcheck's ``transfer_metrics`` scenario (one direct transfer over
    one seeded lossy link) through package ``pkg``; returns the sender,
    the simulator and what was delivered."""
    c = core(pkg)
    sim = c.Simulator(engine=engine)
    if bursty:
        def loss(s):
            return c.GilbertElliott(p_good_loss=loss_p / 4,
                                    p_bad_loss=min(1.0, loss_p * 10),
                                    p_bad=0.075, seed=s)
    else:
        def loss(s):
            return c.BernoulliLoss(p=loss_p, seed=s)

    def mk(s):
        return c.Link(rate_bps, delay_ns, loss(s), jitter_ns=jitter_ns,
                      jitter_seed=s + 77)
    src, dst = "10.1.0.9", "10.0.0.1"
    sim.connect(src, dst, mk(seed), mk(seed + 1))
    tr = flow_module(pkg).maybe_flow(sim, c.make_transport(kind))
    if max_retries is not None:
        cfg_kw["max_retries"] = max_retries
    cfg = c.TransportConfig(kind=kind, mtu=mtu, timeout_ns=timeout_ns,
                            udp_deadline_ns=4 * NS, **cfg_kw)
    got = []
    tr.create_receiver(sim, sim.node(dst), cfg, got.append)
    data = bytes(range(256)) * (payload // 256)
    sender = tr.create_sender(sim, sim.node(src), sim.node(dst),
                              c.packetize(data, src, txn=1, mtu=mtu), cfg)
    sender.start()
    sim.run()
    return {"sim": sim, "sender": sender, "got": got}


def transfer_view(run: dict) -> dict:
    """Everything a transfer decided, as plain values: the simulator's
    stats and clock, the sender's TxnStats and each delivery's sequence
    numbers, payloads and completeness."""
    sim, sender = run["sim"], run["sender"]
    return {"stats": dict(sim.stats), "now_ns": sim.now_ns,
            "txn": dataclasses.asdict(sender.stats),
            "deliveries": [(d.sender_addr, d.txn, d.total, d.complete,
                            sorted((s, p.payload) for s, p in
                                   d.packets.items()))
                           for d in run["got"]]}


def transfer_metrics(engine: str, kind: str, seed: int, **kw) -> dict:
    """statcheck's ``transfer_metrics`` on the port."""
    run = transfer("repro_torch", engine, kind, seed, **kw)
    sim, st = run["sim"], run["sender"].stats
    return {
        "duration_ns": st.duration_ns,
        "sim_end_ns": sim.now_ns,
        "bytes_sent": sim.stats["bytes_sent"],
        "packets_sent": sim.stats["packets_sent"],
        "packets_dropped": sim.stats["packets_dropped"],
        "retransmissions": st.retransmissions,
        "completed": 1.0 if st.completed else 0.0,
        "delivered": float(len(run["got"])),
    }


def fleet(pkg: str, engine: str, transport: str, seed: int, *,
          n_clients: int = 24, rounds: int = 3, topology: str = "star",
          cells: int = 4, neighbors: int = 4, participation: float = 0.5,
          n_params: int = 512, mode: str = "sync",
          deadline_ns: int = 60 * NS) -> dict:
    """statcheck's ``fleet_metrics`` scenario through package ``pkg``
    (the port aggregates on its package device); returns the simulator,
    the system, the objective, the initial loss and each round's result
    and loss (recorded per aggregation, so async runs are seen whole)."""
    c = core(pkg)
    fl = c.FleetConfig(n_clients=n_clients, seed=seed,
                       participation_fraction=participation,
                       round_deadline_ns=deadline_ns, engine=engine,
                       mode=mode, topology=topology,
                       cells=min(cells, n_clients),
                       neighbors=min(neighbors, n_clients - 1))
    objective = c.ConsensusObjective(n_clients, n_params, seed=seed)
    fl_cfg = c.FLConfig(
        aggregation="fedavg",
        transport=c.TransportConfig(kind=transport, timeout_ns=2 * NS,
                                    udp_deadline_ns=3 * NS))
    sim, system, _ = c.build_fleet(fl, objective.init_params(),
                                   objective.train_fn, fl_cfg)
    loss0 = objective.loss(system.global_params)
    results, losses = [], []

    def _on_round(r, params):
        results.append(r)
        losses.append(objective.loss(params))

    system.on_round_end = _on_round
    system.run_rounds(rounds)
    return {"pkg": pkg, "sim": sim, "system": system, "loss0": loss0,
            "results": results, "losses": losses}


def fleet_view(run: dict) -> dict:
    """Everything a fleet run decided, as plain values: the simulator's
    stats, clock and per-hop bytes and packets, each round's record and
    loss, and the global parameters' bytes."""
    sim, system = run["sim"], run["system"]
    c = core(run["pkg"])
    params = np.asarray(c.flatten_to_vector(system.global_params),
                        np.float32)
    return {"stats": dict(sim.stats), "now_ns": sim.now_ns,
            "hop_bytes": dict(sim.hop_bytes),
            "hop_packets": dict(sim.hop_packets),
            "rounds": [dataclasses.asdict(r) for r in run["results"]],
            "losses": run["losses"], "loss0": run["loss0"],
            "params": params.tobytes()}


def fleet_metrics(engine: str, transport: str, seed: int, **kw) -> dict:
    """statcheck's ``fleet_metrics`` on the port."""
    run = fleet("repro_torch", engine, transport, seed, **kw)
    losses = run["losses"]
    durations = [r.duration_ns for r in run["results"]]
    return {
        "round_time_ns": (sum(durations) / len(durations)) if durations
        else 0.0,
        "bytes_on_wire": run["sim"].stats["bytes_sent"],
        "retransmissions": sum(r.retransmissions for r in run["results"]),
        "rounds_to_target": next(
            (i + 1 for i, v in enumerate(losses) if v <= 0.1 * run["loss0"]),
            None),
        "final_loss": losses[-1] if losses else run["loss0"],
    }
