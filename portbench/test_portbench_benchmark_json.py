"""``BENCHMARK.json`` against the benchmark's contract, and its cells
against the files the harness finds by name."""

import json
import re
from pathlib import Path

from portbench import harness

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
TEXT = re.compile(r"[^\n\t]{1,200}")


def load():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_shape_and_names():
    b = load()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"] and b["command"][1:] == [
        "portbench/run.py"]
    assert 1 <= b["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in b[group]]
        assert len(names) == len(set(names))
        assert all(NAME.fullmatch(n) for n in names)
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower",
                                                             "higher")
    for w in b["workloads"]:
        assert TEXT.fullmatch(w["why"]) and w["chips"] in (1, 4)


def test_metrics():
    b = load()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for cell in cells:
        got_e2e, got_layer = harness.cell_metrics(b, cell)
        assert "setup_s" in {m["name"] for m in got_e2e}
        assert len(got_e2e) >= 2 and got_layer


def test_cells_and_configs_are_the_files():
    b = load()
    configs = {c["name"]: c for c in b["configs"]}
    used = set()
    for w in b["workloads"]:
        cell = harness.Cell(w["name"])
        cell.check_entry(b)
        used.add(w["config"])
        assert cell.config["name"] == w["config"]
        assert set(cell.limits) == {"mismatch_share", "max_gap_ulp"}
    assert used == set(configs)
    for c in configs.values():
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert c["file"].startswith("portbench/")
        assert set(c["reduced"]) == set(cfg["reduced"])
        for key in c["reduced"]:
            assert cfg["published"][key] != cfg[key]


def test_run_seconds_fit_the_check_with_24_cells():
    b = load()
    runs = 2 + 14 * 24
    assert runs * (b["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
