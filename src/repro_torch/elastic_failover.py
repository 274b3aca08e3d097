"""Fault tolerance and elasticity at the FL layer, end to end (the
reference's ``examples/elastic_failover.py`` on the port):

 1. a client's uplink dies mid-training -> MUDP exhausts Y=3 retries, the
    round completes without it (straggler cutoff semantics);
 2. the health tracker benches the dead client and re-admits it after the
    cool-down -- it rejoins and contributes again;
 3. a brand-new client joins elastically between rounds;
 4. the server "crashes" after round 2; a fresh process-equivalent restores
    from the atomic checkpoint + journal and resumes at the right round.

Aggregation runs the fedavg kernel on ``--device`` (the card unless told
otherwise); the checkpoints are the FLCK container either package reads.

  PYTHONPATH=src python -m repro_torch.elastic_failover --device cpu
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np

from repro_torch import device as _device
from repro_torch.checkpoint import CheckpointManager, FLJournal
from repro_torch.core import (DropList, FederatedSystem, FLClient, FLConfig,
                              Link, NoLoss, Simulator, TransportConfig)

SERVER = "10.9.0.1"


def const_train(v):
    def fn(params, r, client):
        return {k: np.full_like(p, v) for k, p in params.items()}, {}
    return fn


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=None)
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)

    sim = Simulator()
    params = {"w": np.zeros((5_000,), np.float32)}
    dead_after_round0 = {(s, a) for s in range(1, 100) for a in range(0, 50)}

    clients = []
    for i, loss in ((0, NoLoss()), (1, NoLoss())):
        addr = f"10.9.0.{10 + i}"
        sim.connect(addr, SERVER, Link(1e8, 1_000_000, loss),
                    Link(1e8, 1_000_000))
        clients.append(FLClient(addr, const_train(float(i + 1)),
                                train_time_ns=1_000_000))

    cfg = FLConfig(aggregation="fedavg", broadcast_model=False,
                   unhealthy_after_failures=1, readmit_after_rounds=1,
                   transport=TransportConfig(timeout_ns=500_000_000))
    system = FederatedSystem(sim, SERVER, clients, params, cfg, device=dev)
    for c in clients:
        c.params = params

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="failover_")
    mgr = CheckpointManager(ckpt_dir, keep=3)
    journal = FLJournal(os.path.join(ckpt_dir, "journal.jsonl"))
    system.on_round_end = lambda res, p: journal.round_finalized(
        res.round_idx, mgr.save(res.round_idx, p), res.arrived, res.failed)

    print("round 0: both clients healthy")
    journal.round_started(0, [c.addr for c in clients])
    r0 = system.run_round()
    print(f"  arrived={r0.arrived} failed={r0.failed}")
    assert len(r0.arrived) == 2

    print("round 1: client .11's uplink goes dead (MUDP exhausts retries)")
    sim._links[("10.9.0.11", SERVER)].loss = DropList(dead_after_round0)
    journal.round_started(1, [c.addr for c in clients])
    r1 = system.run_round()
    print(f"  arrived={r1.arrived} failed={r1.failed}")
    assert r1.failed == ["10.9.0.11"]

    print("round 2: dead client is benched; a NEW client joins elastically")
    sim.connect("10.9.0.99", SERVER, Link(1e8, 1_000_000),
                Link(1e8, 1_000_000))
    system.add_client(FLClient("10.9.0.99", const_train(9.0),
                               train_time_ns=1_000_000))
    journal.round_started(2, [c.addr for c in system.pool.active(2)])
    r2 = system.run_round()
    print(f"  arrived={r2.arrived} benched={r2.skipped_unhealthy}")
    assert "10.9.0.11" in r2.skipped_unhealthy
    assert "10.9.0.99" in r2.arrived

    print("server crash! restoring from checkpoint + journal ...")
    j2 = FLJournal(os.path.join(ckpt_dir, "journal.jsonl"))
    restored, meta = mgr.restore(params)
    resume = j2.resume_round()
    print(f"  restored checkpoint of round {meta['step']}, resume at round "
          f"{resume}")
    assert resume == 3
    np.testing.assert_allclose(restored["w"], system.global_params["w"])

    print("round 3 (post-restart): link healed -> .11 re-admitted")
    sim._links[("10.9.0.11", SERVER)].loss = NoLoss()
    # the crashed server process is gone: detach every old transport handler
    # before the restarted process installs its own
    sim.node(SERVER)._handlers.clear()
    for c in system.pool.clients.values():
        sim.node(c.addr)._handlers.clear()
    system2 = FederatedSystem(sim, SERVER, list(system.pool.clients.values()),
                              restored, cfg, device=dev)
    for c in system2.pool.clients.values():
        c.params = restored
    r3 = system2.run_round(resume)
    print(f"  arrived={r3.arrived}")
    assert "10.9.0.11" in r3.arrived
    print("\nOK: failure detected, benched, elastic join, crash-restart, "
          "re-admission -- all green.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
