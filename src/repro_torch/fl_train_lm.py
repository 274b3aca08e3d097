"""Federated training of a language model over the Modified UDP (the
reference's ``examples/fl_train_lm.py`` on the port).

Each FL client trains an xLSTM on its own data shard on the device;
between rounds, model deltas are packetized, int8-compressed with error
feedback (the legacy ``int8`` codec with ``send_deltas``: the quantize and
dequantize kernels), and shipped through lossy WAN links with the paper's
MUDP reliability.  The server averages the deltas (the fedavg kernel,
through ``aggregation.weighted_sum_stack``), checkpoints every round with
the journal beside it, and a straggler deadline keeps slow clients from
stalling the fleet.

The default is the smoke xLSTM (~1M parameters); ``--scale 100m`` is
the reference's ~140M-parameter configuration, same code path.  Runs on
the card unless ``--device`` says otherwise:

  PYTHONPATH=src python -m repro_torch.fl_train_lm --rounds 6 --clients 3 \
      --device cpu
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import os
import sys
import tempfile
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.checkpoint import CheckpointManager, FLJournal
from repro_torch.configs import get_config, smoke_variant
from repro_torch.core import (WAN_LINK, BernoulliLoss, FederatedSystem,
                              FLClient, FLConfig, Link, Simulator,
                              TransportConfig)
from repro_torch.data import federated_partitions
from repro_torch.models import model as M
from repro_torch.optim import AdamW, TrainState, constant
from repro_torch.tree import tree_leaves, tree_map

SERVER = "10.0.0.1"


def model_config(scale: str):
    base = smoke_variant(get_config("xlstm-350m"))
    if scale == "tiny":
        return base
    if scale == "100m":
        return dataclasses.replace(
            base, num_layers=16, d_model=640, num_heads=4, head_dim=160,
            vocab_size=50304, slstm_every=8)
    raise ValueError(scale)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--clients", type=int, default=3)
    ap.add_argument("--local-steps", type=int, default=8)
    ap.add_argument("--scale", choices=["tiny", "100m"], default="tiny")
    ap.add_argument("--loss-rate", type=float, default=0.05)
    ap.add_argument("--codec", default="int8",
                    choices=["raw", "hex", "int8", "topk"])
    ap.add_argument("--non-iid", type=float, default=0.3)
    ap.add_argument("--straggler", action="store_true",
                    help="make the last client 10x slower + round deadline")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    return ap


def _to_numpy(tree: Any) -> Any:
    """A parameter tree as float32 numpy arrays (what the server ships)."""
    return tree_map(lambda t: (t.detach().to("cpu", torch.float32).numpy()
                               if isinstance(t, torch.Tensor)
                               else np.asarray(t, np.float32)), tree)


class _Clock:
    """Seconds spent inside wrapped calls, by label."""

    def __init__(self):
        self.s: dict[str, float] = {}

    def wrap(self, label: str, fn):
        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.s[label] = self.s.get(label, 0.0) + (
                    time.perf_counter() - t0)
        return timed

    def take(self) -> dict[str, float]:
        out, self.s = self.s, {}
        return out


def run(args: argparse.Namespace, global_params: Optional[Any] = None
        ) -> list[dict]:
    """Run the rounds of ``args`` (from :func:`parser`), printing the
    reference's lines, from ``global_params`` (a tree of tensors or numpy
    arrays in the model's layout; a seed-0 init on the device when None).
    Returns one record a round: the round result's ``t_ns``, ``arrived``,
    ``retx``, ``wire_bytes``, the eval NLL, the round's host wall time
    and its split (``train_s`` in local steps, ``wire_s`` in the codec's
    encode and decode, ``ckpt_s`` in the checkpoint save), plus
    ``resume_round`` (the journal's) and ``first_nll`` on the last."""
    dev = _device.resolve(args.device)
    cfg = model_config(args.scale)
    opt = AdamW(schedule=constant(2e-3), weight_decay=0.0)
    loss_fn = M.loss_fn(cfg, remat_policy="none")
    step_fn = M.make_train_step(cfg, opt)
    clock = _Clock()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    pipes = federated_partitions(cfg.vocab_size, 64, 8, args.clients,
                                 seed=0, non_iid=args.non_iid)

    def make_train_fn(idx):
        def train(params, round_idx, client):
            t0 = time.perf_counter()
            p = tree_map(lambda a: torch.from_numpy(
                np.ascontiguousarray(a, np.float32)).to(dev), params)
            state = TrainState(torch.zeros((), dtype=torch.int32,
                                           device=dev), p, opt.init(p))
            losses = []
            # The batches are pure functions of the step, so they are drawn
            # on a thread pool (numpy releases the GIL while it samples)
            # ahead of the steps that consume them, in order.
            first = round_idx * args.local_steps
            with concurrent.futures.ThreadPoolExecutor(
                    min(args.local_steps, os.cpu_count() or 1)) as pool:
                for batch in pool.map(pipes[idx].batch,
                                      range(first, first + args.local_steps)):
                    state, metrics = step_fn(state, batch)
                    losses.append(float(metrics["loss"]))
            out = _to_numpy(state.params)
            sync()
            clock.s["train"] = clock.s.get("train", 0.0) + (
                time.perf_counter() - t0)
            return out, {"first_loss": losses[0], "last_loss": losses[-1]}
        return train

    # WAN topology with IID Bernoulli loss on every uplink.
    sim = Simulator()
    clients = []
    for i in range(args.clients):
        addr = f"10.0.1.{10 + i}"
        up = Link(WAN_LINK["data_rate_bps"], WAN_LINK["delay_ns"],
                  BernoulliLoss(p=args.loss_rate, seed=i))
        down = Link(WAN_LINK["data_rate_bps"], WAN_LINK["delay_ns"])
        sim.connect(addr, SERVER, up, down)
        tt = 2_000_000_000 * (10 if (args.straggler
                                     and i == args.clients - 1) else 1)
        clients.append(FLClient(addr, make_train_fn(i), train_time_ns=tt,
                                weight=1.0))

    if global_params is None:
        gen = torch.Generator(device=dev).manual_seed(0)
        global_params = M.init(cfg, gen, dev)
    global_params = _to_numpy(global_params)
    n_params = sum(int(a.size) for a in tree_leaves(global_params))
    print(f"model: {cfg.name}-derived, {n_params/1e6:.1f}M params, "
          f"{args.clients} clients, codec={args.codec}, "
          f"loss_rate={args.loss_rate}")

    fl_cfg = FLConfig(
        aggregation="fedavg",
        send_deltas=True,
        error_feedback=(args.codec in ("int8", "topk")),
        transport=TransportConfig(kind="mudp", codec=args.codec, mtu=9000,
                                  timeout_ns=3_000_000_000, max_retries=3),
        round_deadline_ns=(90_000_000_000 if args.straggler else None),
    )
    system = FederatedSystem(sim, SERVER, clients, global_params, fl_cfg,
                             device=dev)
    core = system.core
    for obj, names in ((core.uplink_pipeline, ("encode", "decode")),
                       (core.packetizer, ("encode_bytes", "from_packets"))):
        for name in names:
            setattr(obj, name, clock.wrap("wire", getattr(obj, name)))

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="fl_ckpt_")
    mgr = CheckpointManager(ckpt_dir, keep=2)
    journal = FLJournal(os.path.join(ckpt_dir, "journal.jsonl"))

    def on_round_end(result, params):
        t0 = time.perf_counter()
        path = mgr.save(result.round_idx, params,
                        {"round": result.round_idx})
        clock.s["ckpt"] = clock.s.get("ckpt", 0.0) + (
            time.perf_counter() - t0)
        journal.round_finalized(result.round_idx, path, result.arrived,
                                result.failed)

    system.on_round_end = on_round_end

    eval_pipe = federated_partitions(cfg.vocab_size, 64, 16, 1, seed=77)[0]
    eval_batch = M.batch_to(eval_pipe.batch(0), dev)

    def eval_nll(params):
        with torch.no_grad():
            p = tree_map(lambda a: torch.from_numpy(a).to(dev), params)
            return float(loss_fn(p, eval_batch))

    first_nll = eval_nll(system.global_params)
    print(f"round -: eval NLL {first_nll:.4f} "
          f"(ln V = {np.log(cfg.vocab_size):.2f})")
    records = []
    for r in range(args.rounds):
        journal.round_started(r, [c.addr for c in clients])
        clock.take()
        t0 = time.perf_counter()
        res = system.run_round()
        sync()
        wall = time.perf_counter() - t0
        split = clock.take()
        nll = eval_nll(system.global_params)
        print(f"round {r}: t={res.duration_ns/1e9:7.2f}s  "
              f"arrived={len(res.arrived)}/{args.clients} "
              f"retx={res.retransmissions:3d} "
              f"wire={res.bytes_sent/1e6:7.1f}MB  eval NLL {nll:.4f}",
              flush=True)
        records.append({"round": r, "t_ns": res.duration_ns,
                        "arrived": list(res.arrived),
                        "retx": res.retransmissions,
                        "wire_bytes": res.bytes_sent, "nll": nll,
                        "wall_s": wall,
                        "train_s": split.get("train", 0.0),
                        "wire_s": split.get("wire", 0.0),
                        "ckpt_s": split.get("ckpt", 0.0)})

    print(f"\ncheckpoints + journal in {ckpt_dir}")
    print(f"resume round would be: {journal.resume_round()}")
    if records:
        records[-1]["resume_round"] = journal.resume_round()
        records[-1]["first_nll"] = first_nll
    return records


def main(argv: list[str] | None = None) -> int:
    run(parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
