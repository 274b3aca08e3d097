"""Serving driver: batched greedy decode with the per-family cache, the
reference's ``repro.launch.serve`` on the port.  As there, a decoder-only
model's prompt goes through decode steps against a full-size cache; an
encoder-decoder model encodes seeded frames (B, encoder_seq, d_model) in
its dtype (the stubbed audio frontend's output) and prefills the prompt
(the flash attention kernel on the card), and its cache is grown to the
full length.  Then greedy generation follows.  Runs on the card unless
``--device`` says otherwise.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-350m \
      --smoke --batch 2 --prompt-len 16 --gen 8 --device cpu
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import device as _device
from repro_torch.configs import ARCH_IDS, get_config, smoke_variant
from repro_torch.models import model as M
from repro_torch.models import transformer as T


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="xlstm-350m", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    if not cfg.has_decoder:
        raise SystemExit(f"{args.arch} has no decode step")
    dev = _device.resolve(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = M.init(cfg, gen, dev)
    B, P, G = args.batch, args.prompt_len, args.gen
    prompt = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                           device=dev)

    decode = M.make_decode_step(cfg)
    max_len = P + G
    with torch.no_grad():
        if cfg.family == "encdec":
            frames = torch.randn((B, cfg.encoder_seq, cfg.d_model),
                                 generator=gen, device=dev).to(
                getattr(torch, cfg.dtype))
            lg, cache = M.make_prefill_step(cfg)(
                params, {"tokens": prompt, "frames": frames})
            cache = T.grow_cache(cache, max_len)
        else:
            # feed the prompt through decode steps against a full-size cache
            cache = M.init_cache(cfg, B, max_len, dev)
            for t in range(P):
                lg, cache = decode(params, cache, prompt[:, t:t + 1])
        next_tok = torch.argmax(lg, dim=-1)[:, None]

        out = [next_tok]
        t0 = time.time()
        for _ in range(G - 1):
            lg, cache = decode(params, cache, next_tok)
            next_tok = torch.argmax(lg, dim=-1)[:, None]
            out.append(next_tok)
        gen_toks = torch.cat(out, dim=1).cpu()
        dt = time.time() - t0
    print(f"arch={cfg.name} generated {tuple(gen_toks.shape)} tokens "
          f"({(G - 1) * B / max(dt, 1e-9):.1f} tok/s on {dev})")
    for b in range(B):
        print(f"  seq{b}: {gen_toks[b].tolist()}")


if __name__ == "__main__":
    main()
