"""``BENCHMARK.json`` against the benchmark's contract, and its cells
against the files the harness finds by name (the checks of
``portbench/contract.py``, on the repository)."""

import json
from pathlib import Path

from portbench import contract

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_shape_and_names():
    contract.shape_and_names(ROOT, load())


def test_metrics():
    contract.metrics(ROOT, load())


def test_cells_and_configs_are_the_files():
    contract.cells_and_configs(ROOT, load())


def test_every_step_kind_brings_its_fault_tests():
    contract.fault_tests(ROOT, load())


def test_run_seconds_fit_the_check_with_24_cells():
    b = load()
    runs = 2 + 14 * 24
    assert runs * (b["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
