"""The benchmark harness: find a cell's files by name, run its step kind
round after round for a window, and reduce the run to one result.

A cell is ``workloads/<cell>.json``: its configuration, its traffic,
the chips it takes, why it exists, the limits of its comparison and the
precision of its control.  The harness finds the rest by name:

* ``configs/<config>.json``: the sizes, as they are run;
* ``traffic/<traffic>.json``: the traffic's parameters, among them the
  step kind;
* ``steps/<step>.py``: the step kind, a class ``Step`` (see
  ``steps/fl_aggregate.py`` for what it offers) and ``CHECKS``, the
  names of the numbers its comparison reads, which are the keys of the
  cell's limits;
* ``metrics/<metric>.py``: a per-layer metric's reader, ``read(trace)``
  over a :class:`portbench.trace.Trace`, returning a number or None where
  it finds nothing to read; ``CALLS``, the wrappers whose calls in one
  round it needs (recorded before the traced window), as
  ``"module:function"``.

``BENCHMARK.json`` at the root of the checkout names the metrics each
cell reports.  Nothing here names a cell.
"""

from __future__ import annotations

import collections
import contextlib
import importlib.util
import json
import math
import re
import sys
import time
from pathlib import Path
from typing import Optional

from portbench import trace as tr

HERE = Path(__file__).resolve().parent
#: top-level modules that may not be loaded in the process that prints a
#: result: JAX and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: seconds of rounds, at the warm-up's pace, that the window may send
#: ahead of the oldest round it waits for
AHEAD_S = 4.0


def load_json(root: Path, kind: str, name: str) -> dict:
    path = Path(root) / kind / f"{name}.json"
    if not path.is_file():
        raise LookupError(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def load_module(root: Path, kind: str, name: str):
    """The Python file ``<root>/<kind>/<name>.py`` as a module."""
    path = Path(root) / kind / f"{name}.py"
    if not path.is_file():
        raise LookupError(f"no {kind[:-1]} named {name!r} ({path})")
    mod_name = f"_portbench_{kind}_" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A cell's files, found by name under ``root``."""

    def __init__(self, name: str, root: Path = HERE):
        self.name, self.root = name, Path(root)
        self.spec = load_json(root, "workloads", name)
        self.config = load_json(root, "configs", self.spec["config"])
        self.traffic = load_json(root, "traffic", self.spec["traffic"])
        self.step_kind = load_module(root, "steps", self.traffic["step"])
        self.limits: dict = dict(self.spec["limits"])
        if set(self.limits) != set(self.step_kind.CHECKS):
            raise ValueError(f"cell {self.name!r} limits "
                             f"{sorted(self.limits)} but its step kind "
                             f"{self.traffic['step']!r} compares "
                             f"{sorted(self.step_kind.CHECKS)}")

    def correct(self, checks: dict) -> bool:
        """Whether a comparison's readings are each within the cell's
        limit."""
        if set(checks) != set(self.limits):
            raise ValueError(f"cell {self.name!r} limits "
                             f"{sorted(self.limits)} but its comparison "
                             f"reads {sorted(checks)}")
        return all(checks[k] <= self.limits[k] for k in checks)

    def step(self, seed: int, device):
        return self.step_kind.Step(self.config, self.traffic, seed, device)

    def check_entry(self, bench: dict) -> None:
        """Raise unless ``BENCHMARK.json`` lists this cell as its file
        does."""
        entry = next((w for w in bench["workloads"]
                      if w["name"] == self.name), None)
        if entry is None:
            raise LookupError(f"BENCHMARK.json has no cell {self.name!r}")
        for key in ("config", "traffic", "chips"):
            if entry[key] != self.spec[key]:
                raise ValueError(f"cell {self.name!r}: BENCHMARK.json has "
                                 f"{key} {entry[key]!r}, its file "
                                 f"{self.spec[key]!r}")


def cell_metrics(bench: dict, cell: str) -> tuple[list, list]:
    """The end-to-end and per-layer metrics ``bench`` has ``cell``
    report."""
    def listed(m):
        return "workloads" not in m or cell in m["workloads"]
    e2e = [m for m in bench["end_to_end"] if listed(m)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (cell in m["workloads"] if "workloads" in m
                 else m["moves"] in moved)]
    return e2e, layer


def p95(values: list[float]) -> float:
    """The 95th percentile by nearest rank: the smallest value that at
    least 95% of ``values`` do not exceed."""
    s = sorted(values)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


def forbidden_modules() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


class Device:
    """The waits and clocks of the device the run uses: on a card, CUDA
    events around each round and a synchronize; on the CPU, nothing to
    wait for and no device clock."""

    def __init__(self, device: str):
        import torch
        self.torch = torch
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"

    def touch(self) -> None:
        """Make the device's context (on a card: the CUDA context)."""
        if self.cuda:
            self.torch.empty(1, device=self.device)
            self.sync()

    def sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize(self.device)

    def event(self):
        if not self.cuda:
            return None
        ev = self.torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev


def _window(step, dev: Device, seconds: float, judged: int,
            annotate=None, ahead: int = 1
            ) -> tuple[int, float, list[float]]:
    """Rounds sent back to back until ``seconds`` have passed and a round
    on input tree ``judged`` has been sent; then nothing more is sent, the
    device finishes all that was, and the clock is read after that wait:
    (rounds, window seconds, each round's device milliseconds).

    No round waits for the one before it: the device runs them in order
    on one stream while the host sends the next, so that a host that
    stands still for a while leaves the device work to do.  At most
    ``ahead`` rounds are in flight; the host waits for the oldest one
    beyond that."""
    rounds = []
    in_flight: collections.deque = collections.deque()
    start = time.perf_counter()
    i = 0
    while True:
        with annotate("round") if annotate else contextlib.nullcontext():
            ev0 = dev.event()
            step.run(i)
            ev1 = dev.event()
        i += 1
        if ev1 is not None:
            rounds.append((ev0, ev1))
            in_flight.append(ev1)
            while len(in_flight) > ahead:
                in_flight.popleft().synchronize()
        if (time.perf_counter() - start >= seconds
                and (i - 1) % step.n_inputs == judged):
            break
    dev.sync()
    end = time.perf_counter()
    return i, end - start, [a.elapsed_time(b) for a, b in rounds]


def run(cell_name: str, seed: int, seconds: float, trace: bool, *,
        bench: dict, root: Path = HERE, device: str = "cuda",
        t0: Optional[float] = None, chips: int = 1) -> dict:
    """One run of a cell: set-up, a window of ``seconds`` of rounds,
    the comparison, and the result as the benchmark prints it.  On a CPU
    device the same loop runs (a rehearsal) and the result carries no
    metric and no device reading."""
    t0 = time.perf_counter() if t0 is None else t0
    cell = Cell(cell_name, root)
    cell.check_entry(bench)
    e2e, layer = cell_metrics(bench, cell_name)
    readers = {m["name"]: load_module(root, "metrics", m["name"])
               for m in layer} if trace else {}
    dev = Device(device)
    torch = dev.torch
    phases = {"start": time.perf_counter() - t0}
    dev.touch()
    phases["context"] = time.perf_counter() - t0

    step = cell.step(seed, device)
    step.setup()
    dev.sync()
    phases["inputs"] = time.perf_counter() - t0
    # a traced run records the wrapper calls of its last warm-up round,
    # so that nothing is wrapped around the calls of the traced rounds
    targets = [t for r in readers.values() for t in getattr(r, "CALLS", ())]
    # each warm-up round waits for the device, and the fastest one sets
    # how many rounds the window may send ahead
    warm = step.warm_rounds()
    fastest = math.inf
    for i in range(warm - 1):
        t = time.perf_counter()
        step.run(i)
        dev.sync()
        fastest = min(fastest, time.perf_counter() - t)
    with tr.Capture(targets) as capture:
        step.run(warm - 1)
        dev.sync()
    calls = dict(capture.calls)
    ahead = max(2, math.ceil(AHEAD_S / fastest)) if fastest > 0 else 2
    setup_s = time.perf_counter() - t0
    phases["warm"] = setup_s
    print(f"portbench: set-up of {cell_name} (s from start): " + ", ".join(
        f"{k} {v:.3f}" for k, v in phases.items()), file=sys.stderr,
        flush=True)

    # the window closes after the first round past ``seconds`` on the
    # input tree the seed draws, whose output is then judged
    judged = seed % step.n_inputs
    with contextlib.ExitStack() as stack:
        prof = None
        if trace and dev.cuda:
            from torch.profiler import ProfilerActivity, profile
            prof = stack.enter_context(profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]))
        rounds, window_s, device_ms = _window(
            step, dev, seconds, judged, tr.annotate if trace else None,
            ahead)

    result = {"correct": False, "attempted": rounds, "failed": 0,
              "metrics": {}, "device": {"platform": "cpu", "count": 0}}
    if dev.cuda:
        result["device"] = {
            "platform": "gpu", "kind": torch.cuda.get_device_name(dev.device),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    if dev.cuda and not trace:
        values = {"step_ms": window_s / rounds * 1e3,
                  "step_p95_ms": p95(device_ms), "setup_s": setup_s}
        for m in e2e:
            if m["name"] not in values:
                raise LookupError(f"no end-to-end reading named "
                                  f"{m['name']!r}")
            result["metrics"][m["name"]] = {"value": values[m["name"]],
                                            "unit": m["unit"]}
    if prof is not None:
        t = tr.reduce(prof, calls, step)
        del prof
        for m in layer:
            value = readers[m["name"]].read(t)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}
        result["device"].update(busy_s=t.busy_s, window_s=t.window_s)
        result["breakdown"] = t.breakdown()
        del t

    step.close()
    checks = step.judge()
    result["correct"] = cell.correct(checks)
    result["failed"] = 0 if result["correct"] else 1
    result["checks"] = {k: {"value": checks[k], "limit": cell.limits[k]}
                        for k in checks}
    return result
