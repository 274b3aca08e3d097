"""Federated MNIST over the Modified UDP: the port's main path, end to end.

A hand-wired star of ``n_clients`` clients around one server, each on a
100 Mb/s, 1 ms link whose uplink drops payload packets with
``BernoulliLoss(LOSS_P)``.  Every round the server broadcasts the model
(``raw`` downlink), each client trains the paper's MLP on its dirichlet
shard on the device, ships the update through the self-describing
``UPLINK`` pipeline (``int8(1024)``: the quantize kernel) over ``mudp``,
and the server decodes all uplinks in one batch (the dequantize kernel)
and folds them with FedAvg (the fedavg kernel).

Run it on the CPU (the plain PyTorch versions of the kernels) with::

    PYTHONPATH=src python -m repro_torch.fl_mnist --device cpu --rounds 10
"""

from __future__ import annotations

import argparse
import json
import time

from repro_torch import device as _device
from repro_torch.core.channel import BernoulliLoss, Link, NoLoss
from repro_torch.core.rounds import FederatedSystem, FLClient, FLConfig
from repro_torch.core.simulator import Simulator
from repro_torch.core.transport import TransportConfig
from repro_torch.models.mlp import MnistMLPModel

SERVER = "10.0.0.1"
LOSS_P = 0.10            # uplink payload loss of every client
UPLINK = "int8(1024)"    # the uplink wire pipeline
ENGINE = "batched"       # the simulator's packet engine
SEED = 0                 # data, shards and initial weights


def client_addr(i: int) -> str:
    return f"10.0.{1 + i // 250}.{1 + i % 250}"


def build(n_clients: int = 16, *, hidden: int = 32,
          device: _device.DeviceLike | None = None,
          **model_kwargs) -> tuple[FederatedSystem, MnistMLPModel]:
    """The star, its model and its :class:`FederatedSystem` (not yet run).
    ``model_kwargs`` go to :class:`MnistMLPModel` (steps, lr, data sizes)."""
    dev = _device.resolve(device)
    model = MnistMLPModel(n_clients, seed=SEED, hidden=hidden, device=dev,
                          **model_kwargs)
    sim = Simulator(engine=ENGINE)
    clients = []
    for i in range(n_clients):
        addr = client_addr(i)
        sim.connect(addr, SERVER,
                    Link(1e8, 1_000_000, BernoulliLoss(p=LOSS_P,
                                                       seed=1000 + i)),
                    Link(1e8, 1_000_000, NoLoss()))
        clients.append(FLClient(addr, model.train_fn(i)))
    cfg = FLConfig(aggregation="fedavg",
                   transport=TransportConfig(kind="mudp", uplink=UPLINK))
    system = FederatedSystem(sim, SERVER, clients, model.init_params(), cfg,
                             device=dev)
    return system, model


def run(rounds: int = 10, **build_kwargs) -> list[dict]:
    """Build and run ``rounds`` sync rounds; one record per round, the
    first (``round`` 0) being the untrained model.  ``wall_s`` is the
    host wall time of the round, ending after the device is idle."""
    system, model = build(**build_kwargs)

    def _idle():
        if model.device.type == "cuda":
            import torch
            torch.cuda.synchronize(model.device)

    records = [{"round": 0, "accuracy": model.accuracy(system.global_params)}]
    for r in range(1, rounds + 1):
        t0 = time.perf_counter()
        res = system.run_round()
        _idle()
        wall = time.perf_counter() - t0
        records.append({
            "round": r, "accuracy": model.accuracy(system.global_params),
            "arrived": len(res.arrived), "failed": len(res.failed),
            "packets_sent": res.packets_sent,
            "packets_dropped": res.packets_dropped,
            "retransmissions": res.retransmissions,
            "decode_errors": res.decode_errors, "wall_s": wall})
    return records


def profile(trace_path: str, rounds: int = 3, **build_kwargs) -> dict:
    """Trace ``rounds`` rounds (after one untraced warm-up round) with
    ``torch.profiler`` on a CUDA device and write the chrome trace to
    ``trace_path``.  Returns the host wall time of the traced rounds, the
    device busy time (union of kernel, memcpy and memset intervals in the
    trace), the idle share, and device time by kernel."""
    import torch
    from torch.profiler import ProfilerActivity
    system, model = build(**build_kwargs)
    if model.device.type != "cuda":
        raise RuntimeError("profile() measures a CUDA device")
    system.run_round()
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(rounds):
            system.run_round()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(trace_path)
    return {"rounds": rounds, "wall_s": wall,
            **trace_summary(trace_path, wall)}


def trace_summary(trace_path: str, wall_s: float) -> dict:
    """Device busy time of a chrome trace written by ``torch.profiler``
    (union of kernel, memcpy and memset intervals), its idle share of the
    host wall time ``wall_s``, and the device time of the busiest kernels."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    spans, by_name = [], {}
    for ev in events:
        if ev.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") \
                and "dur" in ev:
            spans.append((float(ev["ts"]), float(ev["ts"]) + ev["dur"]))
            by_name[ev["name"]] = by_name.get(ev["name"], 0.0) + ev["dur"]
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {"device_busy_s": busy_us / 1e6,
            "idle_share": 1.0 - busy_us / 1e6 / wall_s,
            "device_events": len(spans),
            "top_device_us": {name[:80]: us for name, us in top}}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--clients", type=int, default=16)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--profile", metavar="TRACE_JSON", default=None,
                    help="trace --rounds rounds on the card with "
                         "torch.profiler, write the chrome trace here and "
                         "print the device busy time and idle share")
    args = ap.parse_args(argv)
    kw = dict(n_clients=args.clients, device=args.device)
    if args.profile:
        print(json.dumps(profile(args.profile, args.rounds, **kw)))
        return
    for rec in run(args.rounds, **kw):
        print(json.dumps(rec))


if __name__ == "__main__":
    main()
