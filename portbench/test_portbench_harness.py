"""The harness on the CPU: the round loop through the same step kind the
card runs, the files it finds by name, and ``run.py`` without a card."""

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from portbench import contract, harness, trace

HERE = Path(__file__).resolve().parent


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("pods,mode", [(4, "int8"), (2, "exact")])
def test_round_loop_on_cpu(tiny, pods, mode, traced):
    root, name, bench = tiny(pods, mode)
    res = harness.run(name, 2 ** 31 + 11, 0.05, traced, bench=bench,
                      root=root, device="cpu")
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    # a CPU rehearsal emits no device metric and no device reading
    assert res["metrics"] == {} and "breakdown" not in res
    assert res["device"] == {"platform": "cpu", "count": 0}
    assert list(res)[-1] == "checks"
    assert res["checks"] == {"mismatch_share": {"value": 0.0, "limit": 0.0},
                             "max_gap_ulp": {"value": 0.0, "limit": 0.0}}


def test_window_ends_on_the_seeds_input(tiny):
    root, name, bench = tiny(2, "exact")
    cell = harness.Cell(name, root)
    for seed in (4, 7):
        step = cell.step(seed, "cpu")
        step.setup()
        rounds, _, _ = harness._window(step, harness.Device("cpu"), 0.0,
                                       seed % step.n_inputs)
        assert (rounds - 1) % step.n_inputs == seed % step.n_inputs
        assert step.last == seed % step.n_inputs


class _Log:
    """A device that records, in order, what the window does with it:
    rounds sent, waits on a round's closing event, and the synchronize."""

    class Event:
        def __init__(self, log, n):
            self.log, self.n = log, n

        def synchronize(self):
            self.log.append(("wait", self.n))

        def elapsed_time(self, other):
            return float(other.n - self.n)

    class Step:
        n_inputs = 2

        def __init__(self, log):
            self.log = log

        def run(self, i):
            self.log.append(("run", i))

    def __init__(self, stall_s=0.0):
        self.log, self.stall_s, self.made = [], stall_s, 0

    def event(self):
        self.made += 1
        return self.Event(self.log, self.made)

    def sync(self):
        time.sleep(self.stall_s)
        self.log.append(("sync",))


@pytest.mark.parametrize("ahead", [1, 3])
def test_window_sends_ahead_and_waits_at_its_close(ahead):
    dev = _Log(stall_s=0.05)
    step = _Log.Step(dev.log)
    dev.log = step.log
    rounds, window_s, device_ms = harness._window(step, dev, 0.02, 1,
                                                  ahead=ahead)
    log = dev.log
    sent = [e[1] for e in log if e[0] == "run"]
    assert sent == list(range(rounds)) and (rounds - 1) % 2 == 1
    # no round waits on the device but for the one ``ahead`` rounds back
    # (its closing event is the round's second), and the window ends in
    # one synchronize, after the last round is sent
    waits = [e[1] for e in log if e[0] == "wait"]
    assert waits == [2 * (r + 1) for r in range(rounds - ahead)]
    for k, e in enumerate(log):
        if e[0] == "run" and e[1] >= ahead:
            assert log[k + 1] == ("wait", 2 * (e[1] - ahead + 1))
    assert log[-1] == ("sync",) and log.count(("sync",)) == 1
    # the clock is read after that wait: a stall there counts
    assert window_s >= 0.05
    assert device_ms == [1.0] * rounds


def test_finds_a_new_cell_config_step_and_metric_by_name(tiny):
    root, name, bench = tiny(2, "int8")
    # a new step kind and a new traffic that names it
    (root / "steps" / "fl_aggregate_twice.py").write_text(
        "from portbench.steps.fl_aggregate import CHECKS\n"
        "from portbench.steps.fl_aggregate import Step as Base\n\n\n"
        "class Step(Base):\n"
        "    def run(self, i):\n"
        "        super().run(i)\n"
        "        super().run(i)\n")
    traffic = json.loads((root / "traffic" / "int8.json").read_text())
    traffic["step"] = "fl_aggregate_twice"
    (root / "traffic" / "int8_twice.json").write_text(json.dumps(traffic))
    spec = json.loads((root / "workloads" / f"{name}.json").read_text())
    spec["traffic"] = "int8_twice"
    (root / "workloads" / "new.cell.json").write_text(json.dumps(spec))
    (root / "metrics" / "rounds_seen.py").write_text(
        "def read(trace):\n    return float(trace.rounds)\n")
    bench["workloads"].append(dict(name="new.cell", config=spec["config"],
                                   traffic="int8_twice", chips=1, why="t"))
    bench["per_layer"].append(dict(
        name="rounds_seen", unit="rounds", better="higher",
        source="device_trace", layer="round", moves="step_ms",
        workloads=["new.cell"]))

    cell = harness.Cell("new.cell", root)
    assert cell.config["name"] == spec["config"]
    assert cell.step_kind.Step.__name__ == "Step"
    res = harness.run("new.cell", 5, 0.02, False, bench=bench, root=root,
                      device="cpu")
    assert res["correct"] is True
    _, layer = harness.cell_metrics(bench, "new.cell")
    # its own metric, and those of any step kind, which list no cells
    assert {m["name"] for m in layer} == {*contract.ANY_STEP, "rounds_seen"}
    reader = harness.load_module(root, "metrics", "rounds_seen")
    t = trace.Trace(3, 0, 10, [], [], {}, None)
    assert reader.read(t) == 3.0
    with pytest.raises(LookupError):
        harness.load_module(root, "metrics", "no_such_metric")
    with pytest.raises(LookupError):
        harness.Cell("no.such.cell", root)


def test_cell_must_agree_with_benchmark_json(tiny):
    root, name, bench = tiny(2, "exact")
    entry = next(w for w in bench["workloads"] if w["name"] == name)
    entry["traffic"] = "int8"
    with pytest.raises(ValueError):
        harness.run(name, 1, 0.01, False, bench=bench, root=root,
                    device="cpu")


def test_cell_metrics_follow_benchmark_json(bench):
    """Every cell reports the end-to-end metrics and the per-layer metrics
    of any step kind; an ``fl_aggregate`` cell the pod aggregation's, and
    the codec's where its traffic is ``int8``."""
    contract.cell_reports(HERE.parent, bench)


def test_p95_is_the_nearest_rank():
    assert harness.p95([float(v) for v in range(1, 101)]) == 95.0
    assert harness.p95([3.0]) == 3.0
    assert harness.p95([1.0, 2.0]) == 2.0


def _run_py(cwd: Path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "hymba-1.5b.pod4.int8", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=120)


def test_run_py_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: run.py would measure")
    proc = _run_py(HERE.parent)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "CUDA" in proc.stderr


def test_run_py_refuses_without_the_program(tmp_path):
    shutil.copy(HERE.parent / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run_py(tmp_path)
    assert proc.returncode != 0
    assert proc.stdout == ""
