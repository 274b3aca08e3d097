"""Roofline table from the port's dry-run (the reference's
``benchmarks/roofline.py`` at the H100 SXM's published peaks).

Reads the dry-run's JSON reports (``build/port_dryrun/dryrun*.json``,
later files overriding earlier ones cell by cell), derives the roofline
terms of each (arch x shape x mesh) cell, the dominant bottleneck, the
MODEL_FLOPS / traced-FLOPs usefulness and the MFU bound (useful FLOPs a
device at the bottleneck's speed over the peak), and writes
``build/port_dryrun/roofline.md``: a cell's one-card row (``h100x1``)
and its production-mesh rows (``pod16x16``, ``pod2x16x16``: GiB and
seconds a device, the collective term over ``lowering.NET_BW``) side by
side.  Every number is an estimate: traced FLOPs and bytes over
published peaks, not a measurement.

Make the inputs with:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
      --out build/port_dryrun/dryrun.json
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
      --multi-pod both --out build/port_dryrun/dryrun_mesh.json
then:
  PYTHONPATH=src python -m repro_torch.roofline
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

from repro_torch.launch.lowering import PEAK_FLOPS

OUT_DIR = os.path.join("build", "port_dryrun")

HINTS = {
    ("compute", "moe"): "cut dense-all-experts waste: the grouped dispatch "
                        "computes only the top-k experts",
    ("memory", "train"): "activation traffic: raise arithmetic intensity "
                         "(fused attention, larger microbatch)",
    ("memory", "decode"): "KV-cache reads dominate; an int8 KV cache or a "
                          "grouped-query kernel halves the bytes",
    ("memory", "prefill"): "attention score materialization; the flash "
                           "kernel keeps its tiles in shared memory",
    ("collective", "train"): "per-layer FSDP gathers and TP all-reduces "
                             "cross the network: fewer, larger "
                             "microbatches",
    ("collective", "prefill"): "row-parallel all-reduces of the "
                               "activations: sequence parallelism halves "
                               "them",
    ("collective", "decode"): "a layer's combine and TP all-reduces: more "
                              "requests a step",
}


def load_cells(out_dir: str = OUT_DIR) -> dict:
    cells = {}
    for path in sorted(glob.glob(os.path.join(out_dir, "dryrun*.json"))):
        try:
            with open(path) as f:
                for rec in json.load(f):
                    cells[(rec["arch"], rec["shape"], rec["mesh"])] = rec
        except (json.JSONDecodeError, KeyError):
            continue
    return cells


def derive(rec: dict) -> dict:
    terms = {"compute": rec["compute_s"], "memory": rec["memory_s"],
             "collective": rec["collective_s"]}
    bottleneck = max(terms.values()) or 1e-30
    n = rec["num_devices"] or 1
    useful_per_dev = rec["model_flops_global"] / n
    mfu_bound = useful_per_dev / PEAK_FLOPS / bottleneck
    mode = ("train" if rec["shape"].startswith("train") else
            "prefill" if rec["shape"].startswith("prefill") else "decode")
    fam = ("moe" if "moe" in rec["arch"] or "olmoe" in rec["arch"] else mode)
    hint = HINTS.get((rec["dominant"], "moe")) if fam == "moe" else None
    hint = hint or HINTS.get((rec["dominant"], mode), "")
    return {"bottleneck_s": bottleneck, "mfu_bound": mfu_bound,
            "hint": hint, **terms}


def render_markdown(cells: dict) -> str:
    lines = [
        "| arch | shape | mesh | GiB/dev | fits | compute_s | memory_s | "
        "collective_s | dominant | MODEL_FLOPs | useful/traced | MFU bound | "
        "next lever |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for key in sorted(cells):
        r = cells[key]
        if r["status"] == "skipped":
            lines.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                         f"— | — | — | — | — | skipped | — | — | — | "
                         f"{r['error'][:60]} |")
            continue
        if r["status"] != "ok":
            lines.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                         f"ERROR | | | | | | | | | {r['error'][:60]} |")
            continue
        d = derive(r)
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
            f"{r['bytes_per_device']/2**30:.1f} | "
            f"{'yes' if r.get('fits') else 'no'} | "
            f"{d['compute']:.3e} | {d['memory']:.3e} | "
            f"{d['collective']:.3e} | {r['dominant']} | "
            f"{r['model_flops_global']:.2e} | {r['useful_ratio']:.2f} | "
            f"{d['mfu_bound']*100:.1f}% | {d['hint'][:70]} |")
    return "\n".join(lines)


def bench(out_dir: str = OUT_DIR):
    """CSV rows ``(name, wall_us, derived)``, as the reference's, after
    writing ``roofline.md`` beside the inputs."""
    cells = load_cells(out_dir)
    if not cells:
        return [("roofline/missing_inputs", 0.0,
                 "run repro_torch.launch.dryrun first")]
    rows = []
    ok = [c for c in cells.values() if c["status"] == "ok"]
    table = os.path.join(out_dir, "roofline.md")
    with open(table, "w") as f:
        f.write(render_markdown(cells) + "\n")
    for key in sorted(cells):
        r = cells[key]
        if r["status"] != "ok":
            continue
        d = derive(r)
        rows.append((f"roofline/{r['arch']}/{r['shape']}/{r['mesh']}",
                     0.0,
                     f"dominant={r['dominant']}"
                     f";mfu_bound={d['mfu_bound']*100:.1f}%"
                     f";useful_ratio={r['useful_ratio']:.2f}"
                     f";mem_gib={r['bytes_per_device']/2**30:.1f}"
                     f";fits={'yes' if r.get('fits') else 'no'}"))
    rows.append(("roofline/summary", 0.0,
                 f"cells_ok={len(ok)};table={table}"))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--dir", default=OUT_DIR,
                    help="where the dry-run's reports are and the table "
                         "goes")
    args = ap.parse_args(argv)
    rows = bench(args.dir)
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived}")
    return 1 if rows[0][0] == "roofline/missing_inputs" else 0


if __name__ == "__main__":
    sys.exit(main())
