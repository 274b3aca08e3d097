"""Dry-run of every (architecture x input shape) cell: FLOPs, bytes,
collective bytes, peak memory and roofline terms of each cell's step a
device, estimated by tracing it on the ``meta`` device
(:func:`repro_torch.launch.lowering.estimate_cell`).

Which mesh:
  * no ``--multi-pod``: one H100 (mesh ``h100x1``), the whole cell on
    one card, nothing laid out (what ``chip_smoke.py`` phase 14 holds on
    the card and ``PERF.md`` §5's one-card table reads);
  * ``--multi-pod off|on|both``: the reference's meanings, the
    production mesh ``pod16x16`` (data=16, model=16), ``pod2x16x16``
    (pod=2, data=16, model=16) or both, each cell laid out by the
    reference's rules and traced as rank 0's program over a fake
    process group (``lower_cell``).

The estimate places no tensor on any device and launches nothing, so it
has no ``--device``: it runs anywhere, and its numbers are the card's
only through the published peaks it divides by.  Cells that do not fit
a device are estimated all the same (``fits`` says so).

Attention is costed on the reference's dry-run's routes: ``chunked`` to
prefill and ``einsum`` to train, unless ``--attn-impl`` names one for
every cell.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-12b \\
      --shape prefill_32k --attn-impl einsum
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
      --out build/port_dryrun/dryrun.json
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
      --multi-pod both --out build/port_dryrun/dryrun_mesh.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.launch.lowering import (estimate_cell, lower_cell,
                                         shape_applicable)


def _line(rep) -> str:
    mark = {"ok": "PASS", "skipped": "SKIP", "error": "FAIL"}[rep.status]
    line = f"[{mark}] {rep.arch:22s} {rep.shape:12s} {rep.mesh:10s}"
    if rep.status == "ok":
        line += (f" mem/dev={rep.bytes_per_device / 2**30:7.2f}GiB"
                 f" fits={'yes' if rep.fits else 'no'}"
                 f" flops/dev={rep.hlo_flops:.3e}"
                 f" coll/dev={rep.collective_bytes:.3e}B"
                 f" dominant={rep.dominant}"
                 f" trace={rep.compile_seconds:.0f}s")
    else:
        line += f" {rep.error[:120]}"
    return line


def run_cells(archs, shapes, meshes=(None,), *, attn_impl=None,
              out_path=None, verbose=True):
    """Each cell on each of ``meshes``: ``None`` for one card, ``False``
    for ``pod16x16``, ``True`` for ``pod2x16x16``."""
    reports = []
    for arch in archs:
        cfg = get_config(arch)
        for shape_name in shapes:
            if not shape_applicable(cfg, shape_name):
                continue
            for multi_pod in meshes:
                if multi_pod is None:
                    rep = estimate_cell(arch, shape_name, attn_impl=attn_impl)
                else:
                    rep = lower_cell(arch, shape_name, multi_pod=multi_pod,
                                     attn_impl=attn_impl)
                reports.append(rep)
                if verbose:
                    print(_line(rep), flush=True)
                if out_path:
                    os.makedirs(os.path.dirname(out_path) or ".",
                                exist_ok=True)
                    with open(out_path, "w") as f:
                        json.dump([r.to_json() for r in reports], f,
                                  indent=1)
    return reports


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", action="append", default=None,
                    choices=ARCH_IDS,
                    help="architecture id (repeatable); default: all")
    ap.add_argument("--shape", action="append", default=None,
                    choices=list(SHAPES), help="shape preset (repeatable)")
    ap.add_argument("--all", action="store_true",
                    help="all archs x all shapes")
    ap.add_argument("--attn-impl", choices=["einsum", "chunked"],
                    default=None,
                    help="attention route of every cell (default: chunked "
                         "to prefill, einsum to train)")
    ap.add_argument("--multi-pod", choices=["off", "on", "both"],
                    default=None,
                    help="the production meshes: off = pod16x16, on = "
                         "pod2x16x16, both (default: one card, h100x1)")
    ap.add_argument("--out", default=None, help="JSON report path")
    args = ap.parse_args(argv)
    if not (args.all or args.arch or args.shape):
        ap.error("name cells with --arch / --shape, or pass --all")

    archs = args.arch or ARCH_IDS
    shapes = args.shape or list(SHAPES)
    t0 = time.perf_counter()
    meshes = {None: [None], "off": [False], "on": [True],
              "both": [False, True]}[args.multi_pod]
    reports = run_cells(archs, shapes, meshes, attn_impl=args.attn_impl,
                        out_path=args.out)
    bad = [r for r in reports if r.status == "error"]
    print(f"\n{len(reports)} cells: "
          f"{sum(r.status == 'ok' for r in reports)} ok, "
          f"{sum(r.status == 'skipped' for r in reports)} skipped, "
          f"{len(bad)} failed; {time.perf_counter() - t0:.1f} s")
    for r in bad:
        print(f"  FAIL {r.arch} {r.shape} {r.mesh}: {r.error[:200]}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
