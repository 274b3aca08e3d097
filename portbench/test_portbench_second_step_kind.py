"""A cell of a second step kind, added to a copy of the benchmark as new
files and appended entries only: a seeded bf16 matmul on the CPU, with
its own comparison (``max_rel_err`` against a float64 reference), its own
peak (bf16 on the tensor cores) and its own per-layer metric.  Every
whole-benchmark check passes on the copy, the harness runs the cell
``correct``, and the cell reports the metrics of any step kind and none
of the pod aggregation's.  ``step_mfu`` is pinned on synthetic traces at
each step kind's own peak."""

import json
import shutil
from pathlib import Path

import pytest
import torch

from portbench import contract, harness, trace, work
from portbench.steps import fl_aggregate

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CELL = "toy-matmul.toy"

STEP = '''"""Step kind ``toy_matmul``: ``a @ b`` in bf16, a round, over input
pairs drawn from the seed on the device; judged against the float64
product of the same pair."""

import torch

from portbench import work

CHECKS = ("max_rel_err",)
DIMS = ("rows", "k", "n")


class Step:
    def __init__(self, config, traffic, seed, device):
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, torch.device(device)
        self.inputs, self.out, self.last = [], None, None

    @property
    def n_inputs(self):
        return int(self.traffic["inputs"])

    def setup(self):
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed % (1 << 64))
        m, k, n = (int(self.config[d]) for d in DIMS)

        def draw(shape):
            return torch.randn(shape, generator=gen, device=self.device).to(
                torch.bfloat16)
        self.inputs = [(draw((m, k)), draw((k, n)))
                       for _ in range(self.n_inputs)]

    def warm_rounds(self):
        return int(self.traffic["warmup_rounds"]) * self.n_inputs

    def run(self, i):
        self.out = None
        self.last = i % self.n_inputs
        a, b = self.inputs[self.last]
        self.out = a @ b

    def close(self):
        self.inputs = [x if j == self.last else None
                       for j, x in enumerate(self.inputs)]

    def judge(self):
        a, b = self.inputs[self.last]
        ref = a.double() @ b.double()
        gap = (self.out.double() - ref).abs().max() / ref.abs().max()
        return {"max_rel_err": float(gap)}

    def control(self, arith):
        a, b = self.inputs[self.last]
        self.out = (a.to(arith).float() @ b.to(arith).float()).to(
            torch.bfloat16)

    def round_work(self):
        m, k, n = (int(self.config[d]) for d in DIMS)
        return 2 * (m * k + k * n + m * n), 2 * m * k * n, \\
            work.PEAK_BF16_FLOPS
'''

METRIC = '''"""``toy_matmul_ms``: device milliseconds a round in matmul kernels."""

import re

GEMM = re.compile(r"gemm", re.I)


def read(trace):
    seconds, count = trace.ops_s(GEMM)
    if not trace.rounds or not count:
        return None
    return seconds * 1e3 / trace.rounds
'''

FILES = {
    "steps/toy_matmul.py": STEP,
    "metrics/toy_matmul_ms.py": METRIC,
    "test_portbench_faults_toy_matmul.py":
        '"""The faults a ``toy_matmul`` cell can have."""\n',
    "configs/toy-matmul.json": json.dumps({
        "name": "toy-matmul", "rows": 64, "k": 96, "n": 80,
        "published": {"rows": 8192},
        "reduced": {"rows": "8192 -> 64: a CPU test"}}),
    "traffic/toy.json": json.dumps({
        "step": "toy_matmul", "why": "one bf16 matmul a round",
        "inputs": 2, "warmup_rounds": 1}),
    f"workloads/{CELL}.json": json.dumps({
        "config": "toy-matmul", "traffic": "toy", "chips": 1,
        "why": "a second step kind", "limits": {"max_rel_err": 0.01},
        "control": "float8_e4m3fn"}),
}
ENTRIES = {
    "configs": {"name": "toy-matmul", "source": "https://example.org/toy",
                "file": "portbench/configs/toy-matmul.json",
                "reduced": ["rows"], "why": "a toy second step kind"},
    "workloads": {"name": CELL, "config": "toy-matmul", "traffic": "toy",
                  "chips": 1, "why": "a second step kind on the CPU"},
    "per_layer": {"name": "toy_matmul_ms", "unit": "ms", "better": "lower",
                  "source": "device_trace", "layer": "matmul",
                  "moves": "step_ms", "workloads": [CELL]},
}


def benchmark_files():
    return [p for p in HERE.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts]


@pytest.fixture
def copy(tmp_path):
    """A copy of the benchmark with the toy cell added: (root, bench)."""
    shutil.copytree(HERE, tmp_path / contract.DIR,
                    ignore=shutil.ignore_patterns("__pycache__"))
    for rel, text in FILES.items():
        path = tmp_path / contract.DIR / rel
        assert not path.exists()
        path.write_text(text)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for group, entry in ENTRIES.items():
        bench[group].append(entry)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench, indent=2))
    return tmp_path, bench


def test_the_toy_cell_lands_as_new_files_and_passes_every_check(copy):
    root, bench = copy
    for path in benchmark_files():
        rel = path.relative_to(HERE)
        assert (root / contract.DIR / rel).read_bytes() == path.read_bytes()
    before = json.loads((ROOT / "BENCHMARK.json").read_text())
    for key, value in before.items():
        if isinstance(value, list):
            assert bench[key][:len(value)] == value
        else:
            assert bench[key] == value
    for check in contract.ALL:
        check(root, bench)


def test_the_toy_cell_runs_correct_on_the_cpu(copy):
    root, bench = copy
    res = harness.run(CELL, 2 ** 31 + 5, 0.02, False, bench=bench,
                      root=root / contract.DIR, device="cpu")
    assert res["correct"] is True and res["failed"] == 0
    assert res["checks"]["max_rel_err"]["limit"] == 0.01
    assert 0 < res["checks"]["max_rel_err"]["value"] < 0.01
    # the reference in float8 e4m3 put in the program's place fails it
    cell = harness.Cell(CELL, root / contract.DIR)
    step = cell.step(7, "cpu")
    step.setup()
    step.last = 1
    step.close()
    step.control(torch.float8_e4m3fn)
    assert cell.correct(step.judge()) is False


def test_the_toy_cell_reports_the_metrics_of_any_step_kind(copy):
    _, bench = copy
    e2e, layer = harness.cell_metrics(bench, CELL)
    assert {m["name"] for m in e2e} == set(contract.END_TO_END)
    names = {m["name"] for m in layer}
    assert names == {*contract.ANY_STEP, "toy_matmul_ms"}
    pod = {m["name"] for m in bench["per_layer"]
           if m.get("workloads") and CELL not in m["workloads"]}
    assert pod >= {*contract.FL_AGGREGATE, *contract.FL_AGGREGATE_INT8,
                   "agg_host_ms", "agg_idle_ms"}
    assert not names & pod


@pytest.mark.parametrize("limits", [
    {"max_rel_err": 0.01, "mismatch_share": 0.0},
    {"mismatch_share": 0.0, "max_gap_ulp": 0.0},
    {}], ids=["one_more", "another_kinds", "none"])
def test_cell_refuses_limits_its_step_kind_does_not_compare(copy, limits):
    root, _ = copy
    path = root / contract.DIR / "workloads" / f"{CELL}.json"
    spec = json.loads(path.read_text())
    path.write_text(json.dumps(dict(spec, limits=limits)))
    with pytest.raises(ValueError, match=r"toy_matmul.*max_rel_err"):
        harness.Cell(CELL, root / contract.DIR)


def step_mfu(step, rounds, window_s):
    t = trace.Trace(rounds, 0, round(window_s * 1e9), [], [], {}, step)
    return harness.load_module(HERE, "metrics", "step_mfu").read(t)


def test_step_mfu_of_fl_aggregate_is_the_bytes_over_the_round():
    """The formula before the step kinds named their peaks: the round's
    least bytes over 3.35 TB/s, times the rounds, over the window."""
    cfg = json.loads((HERE / "configs" / "hymba-1.5b.pod4.json").read_text())
    traffic = json.loads((HERE / "traffic" / "exact.json").read_text())
    step = fl_aggregate.Step(cfg, traffic, 0, "cpu")
    assert step.round_work() == (24_395_869_184, 0, work.PEAK_F32_FLOPS)
    got = step_mfu(step, 2, 0.02)
    least = work.bound_s(24_395_869_184, 0)[0]
    assert got == 100.0 * least * 2 / 0.02
    assert got == pytest.approx(72.82349010149254)


def test_step_mfu_of_a_bf16_step_is_taken_at_its_peak(copy):
    """An 8192 x 4096 x 4096 bf16 matmul a round is bound by its
    operations at 989 TFLOP/s: a round as long as that bound reads 100%,
    a longer one less.  At the float32 peak the same round would read
    989 / 67 times as much."""
    root, _ = copy
    toy = harness.load_module(root / contract.DIR, "steps", "toy_matmul")
    step = toy.Step({"rows": 8192, "k": 4096, "n": 4096}, {}, 0, "cpu")
    nbytes, flops, peak = step.round_work()
    assert peak == work.PEAK_BF16_FLOPS == 989e12
    least, which = work.bound_s(nbytes, flops, peak)
    assert which == "operations" and least == flops / 989e12
    for stretch in (1.0, 1.25, 4.0):
        got = step_mfu(step, 3, 3 * least * stretch)
        assert got == pytest.approx(100.0 / stretch, rel=1e-6)
        assert got <= 100.0 * (1 + 1e-6)
    at_f32 = 100.0 * work.bound_s(nbytes, flops)[0] / least
    assert at_f32 == pytest.approx(100.0 * 989 / 67)
