"""What the benchmark loads: nothing it runs has ``jax``, ``jaxlib``,
``flax`` or the JAX package ``repro`` as its top-level module (compared
whole: ``repro_torch`` begins with ``repro``), and the reference imports
nothing of the port.  Each check runs in a fresh interpreter, since the
test process itself loads JAX for other tests."""

import ast
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

LOADED = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def top_level_modules(body: str) -> set:
    code = LOADED.format(root=str(ROOT), src=str(ROOT / "src"), body=body)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    return set(json.loads(proc.stdout.splitlines()[-1]))


def test_harness_and_a_cpu_run_load_no_jax():
    body = """
import runpy, tempfile
from pathlib import Path
from portbench import conftest, harness, run, control
from portbench.reference import fl_aggregate
root = Path(tempfile.mkdtemp())
bench = json.loads((harness.HERE.parent / "BENCHMARK.json").read_text())
for mode in ("int8", "exact"):
    bench["workloads"].append(conftest.write_cell(root, "t." + mode, pods=2,
                                                  mode=mode))
    harness.run("t." + mode, 1, 0.01, True, bench=bench, root=root,
                device="cpu")
for m in bench["per_layer"]:
    harness.load_module(harness.HERE, "metrics", m["name"])
assert not harness.forbidden_modules(), harness.forbidden_modules()
"""
    loaded = top_level_modules(body)
    assert "repro_torch" in loaded and "portbench" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "repro"}


def test_reference_loads_nothing_of_the_port():
    loaded = top_level_modules(
        "from portbench.reference import fl_aggregate")
    assert not loaded & {"repro_torch", "repro", "jax", "jaxlib", "flax"}
    src = (HERE / "reference" / "fl_aggregate.py").read_text()
    names = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert names <= {"__future__", "torch"}
