"""Readings that set a cell's comparison limits, at the cell's own size.

    python3 portbench/control.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 [--arith bfloat16,float8_e4m3fn] [--out FILE]

For each ``--seeds`` seed: the cell's inputs drawn from the seed, its
warm-up and ROUNDS more rounds of the program, and the comparison
of the last round's output (the program's readings: the lower ends of
the limits).  For each ``--control-seeds`` seed and each precision of
``--arith`` (by default the cell file's ``control``): the plain reference
computed with every intermediate result rounded to that precision, put in
the program's place, and the same comparison (the control's readings: the
upper ends).  Each reading is held to the cell's limits as a run's is:
``correct`` has to come out true for the program and false for the
control.  One JSON line a reading on standard output, and in ``--out`` if
given; the exit code is 1 where a reading came out otherwise.  Needs a CUDA card; the benchmark's runs do not run
it.
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: rounds of the program after its warm-up, the last one judged
ROUNDS = 2


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--arith", default="")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from portbench import harness

    if not torch.cuda.is_available():
        print("portbench control: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.Cell(args.workload)
    dev = harness.Device("cuda")
    arith = [a for a in (args.arith or cell.spec["control"]).split(",") if a]
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control_seeds = [int(s) for s in args.control_seeds.split(",") if s]
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    ok = True
    try:
        for kind, seed_list in (("program", seeds), ("control", control_seeds)):
            for seed in seed_list:
                t = time.perf_counter()
                step = cell.step(seed, "cuda")
                step.setup()
                if kind == "program":
                    for i in range(step.warm_rounds() + ROUNDS):
                        step.run(i)
                    dev.sync()
                    step.close()
                    checks = step.judge()
                    ok &= cell.correct(checks)
                    emit({"cell": cell.name, "kind": kind, "seed": seed,
                          **checks, "correct": cell.correct(checks),
                          "s": time.perf_counter() - t})
                else:
                    step.last = seed % step.n_inputs
                    step.close()
                    for a in arith:
                        step.control(getattr(torch, a))
                        dev.sync()
                        checks = step.judge()
                        ok &= not cell.correct(checks)
                        emit({"cell": cell.name, "kind": kind, "arith": a,
                              "seed": seed, **checks,
                              "correct": cell.correct(checks),
                              "s": time.perf_counter() - t})
                del step
                torch.cuda.empty_cache()
    finally:
        if out:
            out.close()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
