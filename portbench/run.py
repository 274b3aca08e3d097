"""The port's benchmark: one run of one cell on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It measures ``repro_torch`` (the PyTorch
and CUDA port, under ``src/``) and nothing else.  The last line of
standard output is the run's result as one JSON object; the numbers that
decide ``correct`` are the last lines of standard error.  Without the
program, without a CUDA card, or with fewer cards than the cell takes, it
prints no result and exits 2; it exits 3 if JAX or the JAX package is loaded once the window
has closed.  See ``portbench/README.md``.
"""

import time

T0 = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: build and kernel caches, at fixed paths inside the checkout
CACHE = ROOT / "build" / "portbench_cache"
# Python's bytecode too: where the environment turns bytecode caches off
# (PYTHONDONTWRITEBYTECODE), every run would compile torch's sources anew,
# seconds of set-up that spread with the host's load
sys.pycache_prefix = str(CACHE / "pyc")
sys.dont_write_bytecode = False

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = _args(argv)
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"portbench: no program under {ROOT / 'src'}; no result",
              file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"]
                  if w["name"] == args.workload), None)
    if entry is None:
        print(f"portbench: BENCHMARK.json has no cell {args.workload!r}",
              file=sys.stderr)
        return 2

    import torch
    t_torch = time.perf_counter() - T0
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < entry["chips"]:
        print(f"portbench: cell {args.workload!r} takes {entry['chips']} "
              f"CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f"; no result", file=sys.stderr)
        return 2

    print(f"portbench: start-up (s from start): torch imported "
          f"{t_torch:.3f}, CUDA found {time.perf_counter() - T0:.3f}",
          file=sys.stderr, flush=True)
    from portbench import harness
    result = harness.run(args.workload, args.seed, args.seconds,
                         bool(args.trace), bench=bench, device="cuda",
                         t0=T0, chips=entry["chips"])
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"portbench: the run loaded {', '.join(loaded)}; no result",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
