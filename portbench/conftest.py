"""Fixtures of the benchmark's CPU tests: a tiny cell written into a
temporary directory, beside copies of the benchmark's step kinds, traffic,
metric readers and reference, and a ``BENCHMARK.json`` that lists it."""

import json
import shutil
from pathlib import Path

import pytest

# the whole-benchmark checks assert outside a test module
pytest.register_assert_rewrite("portbench.contract")

HERE = Path(__file__).resolve().parent

#: a tree with a 16-wide, a 64-wide and a >8,192-wide leaf (quantize's
#: narrow, narrow and wide routes on the card), a 3-d leaf and a 1-d one
TINY_LEAVES = [["narrow", [3, 16], "bfloat16"],
               ["router", [2, 5, 64], "bfloat16"],
               ["unembed", [2, 9000], "bfloat16"],
               ["norm", [40], "bfloat16"]]


def write_cell(root: Path, name: str, *, pods: int, mode: str,
               leaves=TINY_LEAVES, limits=None, control="bfloat16") -> dict:
    """Write cell ``name`` (config ``<name>.cfg``, traffic ``mode``) under
    ``root`` and return its ``BENCHMARK.json`` entry."""
    for sub in ("steps", "traffic", "metrics", "reference"):
        if not (root / sub).exists():
            shutil.copytree(HERE / sub, root / sub)
    (root / "configs").mkdir(exist_ok=True)
    (root / "workloads").mkdir(exist_ok=True)
    cfg = f"{name}.cfg"
    (root / "configs" / f"{cfg}.json").write_text(json.dumps(
        {"name": cfg, "pods": pods, "leaves": leaves}))
    entry = {"name": name, "config": cfg, "traffic": mode, "chips": 1,
             "why": "a tiny tree for the CPU tests"}
    spec = dict(entry, limits=limits or {"mismatch_share": 0.0,
                                         "max_gap_ulp": 0.0},
                control=control)
    del spec["name"]
    (root / "workloads" / f"{name}.json").write_text(json.dumps(spec))
    return entry


@pytest.fixture
def bench():
    """The repository's ``BENCHMARK.json``."""
    return json.loads((HERE.parent / "BENCHMARK.json").read_text())


@pytest.fixture
def tiny(tmp_path, bench):
    """Factory: ``tiny(pods, mode, **kw) -> (root, name, bench)``, a tiny
    cell under a temporary root and a ``BENCHMARK.json`` that lists it
    with the metrics of the repository's cells of the same traffic."""
    def make(pods: int, mode: str, **kw):
        name = f"tiny.pod{pods}.{mode}"
        entry = write_cell(tmp_path, name, pods=pods, mode=mode, **kw)
        b = json.loads(json.dumps(bench))
        b["workloads"].append(entry)
        like = next(w["name"] for w in bench["workloads"]
                    if w["traffic"] == mode)
        for m in b["per_layer"] + b["end_to_end"]:
            if like in m.get("workloads", ()):
                m["workloads"].append(name)
        return tmp_path, name, b
    return make
