"""The whole benchmark against its contract: ``BENCHMARK.json``'s shape and
names, its metrics, its cells and configurations against the files the
harness finds by name, the fault tests each step kind brings, and the
metrics each cell reports.

Each check is a function of ``(root, bench)``: the root of a checkout,
which holds ``BENCHMARK.json`` and ``portbench/``, and that
``BENCHMARK.json`` parsed.  It raises AssertionError at the first breach.
The tests call them on the repository, and on a copy of the benchmark
with a cell of a second step kind added as new files.
"""

from __future__ import annotations

import json
import re
from pathlib import Path

from portbench import harness

#: the benchmark's directory, under a checkout's root
DIR = harness.HERE.name
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
TEXT = re.compile(r"[^\n\t]{1,200}")
PER_LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}
#: what every cell reports, whatever its step kind: the end-to-end metrics,
#: and the per-layer metrics that list no cells, since they read any step
#: kind's trace
END_TO_END = ("step_ms", "step_p95_ms", "setup_s")
ANY_STEP = ("step_mfu", "launches_per_round", "idle_share")
#: what an ``fl_aggregate`` cell reports besides, and what its ``int8``
#: cells alone report: the codec's kernels and the cast before them
FL_AGGREGATE = ("agg_copy_ms", "fedavg_roofline")
FL_AGGREGATE_INT8 = ("quantize_roofline", "dequantize_roofline", "cast_ms")


def _traffic(root: Path, bench: dict) -> dict:
    """Each cell's traffic file, by the cell's name."""
    return {w["name"]: harness.load_json(Path(root) / DIR, "traffic",
                                         w["traffic"])
            for w in bench["workloads"]}


def shape_and_names(root: Path, bench: dict) -> None:
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == [DIR]
    assert bench["command"][1:] == [f"{DIR}/run.py"]
    assert 1 <= bench["run_seconds"] <= 51
    assert len((Path(root) / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in bench[group]]
        assert len(names) == len(set(names)), group
        assert all(NAME.fullmatch(n) for n in names), names
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.fullmatch(m["unit"]), m
        assert m["better"] in ("lower", "higher"), m
    for m in bench["per_layer"]:
        assert TEXT.fullmatch(m["layer"]), m
    for w in bench["workloads"]:
        assert TEXT.fullmatch(w["why"]) and w["chips"] in (1, 4), w
        assert NAME.fullmatch(w["config"]) and NAME.fullmatch(w["traffic"])
    for c in bench["configs"]:
        assert TEXT.fullmatch(c["source"]) and TEXT.fullmatch(c["why"]), c
        assert len(c["reduced"]) <= 16
        assert all(NAME.fullmatch(k) for k in c["reduced"]), c


def metrics(root: Path, bench: dict) -> None:
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}, m
        assert 0.01 <= m["bound"] <= 0.25, m
        assert m["source"] in ("host_clock", "device_trace"), m
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        # a metric lists its cells, or reads every cell that reports the
        # end-to-end metric it moves
        assert PER_LAYER_KEYS <= set(m) <= PER_LAYER_KEYS | {"workloads"}, m
        assert m["moves"] in e2e, m
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock"), m
        if "workloads" in m:
            assert m["workloads"] and set(m["workloads"]) <= cells, m
        assert (Path(root) / DIR / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%", m
    for cell in cells:
        got_e2e, got_layer = harness.cell_metrics(bench, cell)
        reported = {m["name"] for m in got_e2e}
        assert "setup_s" in reported and len(reported) >= 2, cell
        assert got_layer, cell
        # a per-layer metric moves an end-to-end metric its cell reports
        assert {m["moves"] for m in got_layer} <= reported, cell


def cells_and_configs(root: Path, bench: dict) -> None:
    configs = {c["name"]: c for c in bench["configs"]}
    used = set()
    for w in bench["workloads"]:
        # Cell refuses limits that are not its step kind's CHECKS
        cell = harness.Cell(w["name"], Path(root) / DIR)
        cell.check_entry(bench)
        used.add(w["config"])
        assert cell.config["name"] == w["config"]
    assert used == set(configs)
    for name, c in configs.items():
        assert c["file"] == f"{DIR}/configs/{name}.json", c
        cfg = json.loads((Path(root) / c["file"]).read_text())
        assert set(c["reduced"]) == set(cfg["reduced"]), name
        for key in c["reduced"]:
            assert cfg["published"][key] != cfg[key], (name, key)


def fault_tests(root: Path, bench: dict) -> None:
    """Every step kind that a cell uses brings its own fault tests."""
    for step in {t["step"] for t in _traffic(root, bench).values()}:
        path = Path(root) / DIR / f"test_portbench_faults_{step}.py"
        assert path.is_file(), f"step kind {step!r} has no {path.name}"


def cell_reports(root: Path, bench: dict) -> None:
    """The metrics each cell reports: those of any step kind everywhere,
    and the pod aggregation's in the ``fl_aggregate`` cells."""
    for cell, traffic in _traffic(root, bench).items():
        e2e, layer = harness.cell_metrics(bench, cell)
        assert set(END_TO_END) <= {m["name"] for m in e2e}, cell
        names = {m["name"] for m in layer}
        assert set(ANY_STEP) <= names, cell
        if traffic["step"] == "fl_aggregate":
            assert set(FL_AGGREGATE) <= names, cell
            int8 = set(FL_AGGREGATE_INT8)
            assert names & int8 == (int8 if traffic["mode"] == "int8"
                                    else set()), cell


#: every check, in the order the tests run them
ALL = (shape_and_names, metrics, cells_and_configs, fault_tests,
       cell_reports)
