"""Training entry point, the reference's ``repro.launch.train`` on the port.

Runs real optimization steps on one device, the card unless ``--device``
says otherwise:

  PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-350m \
      --smoke --steps 20 --batch 4 --seq 128 --device cpu

``--smoke`` swaps in the reduced same-family config; ``--layers N`` keeps
the config's width and cuts it to its first N layers.  The step runs
eagerly (the reference jit-compiles it).  Checkpoints (the reference's
FLCK container, readable by either package) land in ``--ckpt-dir`` every
``--ckpt-every`` steps and at the end, and training resumes from the
latest checkpoint there automatically (crash-restart story).
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCH_IDS, get_config, smoke_variant
from repro_torch.configs.base import TrainConfig
from repro_torch.data import TokenPipeline
from repro_torch.models import model as M
from repro_torch.optim import cosine_schedule, make_optimizer


def build(arch: str, smoke: bool, train_cfg: TrainConfig, layers: int = 0):
    cfg = get_config(arch)
    if smoke:
        cfg = smoke_variant(cfg)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    opt = make_optimizer(
        train_cfg.optimizer,
        cosine_schedule(train_cfg.learning_rate, train_cfg.warmup_steps,
                        train_cfg.total_steps),
        weight_decay=train_cfg.weight_decay, grad_clip=train_cfg.grad_clip)
    return cfg, opt


def make_batch_fn(cfg, batch, seq, seed=0):
    """Step -> batch of the reference's data pipeline (numpy, the same
    bits), with the reference's extra fields: seeded frames for encdec,
    ``arange`` M-RoPE positions and a zero vision prefix for the VLM."""
    pipe = TokenPipeline(cfg.vocab_size, seq, batch, seed=seed)

    def get(step: int) -> dict:
        b = pipe.batch(step)
        out = {"tokens": b["tokens"], "labels": b["labels"]}
        if cfg.family == "encdec":
            rng = np.random.default_rng(1000 + step)
            out["frames"] = rng.standard_normal(
                (batch, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
        if cfg.mrope:
            out["positions"] = np.broadcast_to(
                np.arange(seq, dtype=np.int32)[None, None], (3, batch, seq))
            out["vision_embeds"] = np.zeros(
                (batch, cfg.vision_tokens, cfg.d_model), np.float32)
        return out

    return get


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="yi-9b", choices=ARCH_IDS)
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the model to its first N layers (0: all)")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "adafactor", "sgd"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    tc = TrainConfig(learning_rate=args.lr, warmup_steps=10,
                     total_steps=args.steps, optimizer=args.optimizer,
                     grad_accum=args.grad_accum, remat_policy="none")
    cfg, opt = build(args.arch, args.smoke, tc, args.layers)
    dev = _device.resolve(args.device)
    step_fn = M.make_train_step(cfg, opt, tc)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    state = M.init_train_state(cfg, opt, gen, dev)

    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, keep=2)
        if mgr.latest_step() is not None:
            restored, meta = mgr.restore(state)
            state = restored
            print(f"resumed from step {meta['step']}")

    get_batch = make_batch_fn(cfg, args.batch, args.seq, args.seed)
    start = int(state.step)
    t0 = time.time()
    for s in range(start, args.steps):
        state, metrics = step_fn(state, get_batch(s))
        if s % args.log_every == 0 or s == args.steps - 1:
            print(f"step {s:5d} loss {float(metrics['loss']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"({(time.time()-t0)/(s-start+1):.2f}s/step)", flush=True)
        if mgr and (s + 1) % args.ckpt_every == 0:
            mgr.save(s + 1, state, {"arch": args.arch})
    if mgr:
        mgr.save(args.steps, state, {"arch": args.arch})
    print("done")


if __name__ == "__main__":
    main()
