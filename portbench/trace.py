"""The traced run's reading: a ``torch.profiler`` window over whole rounds,
the kernel wrappers' calls of one round captured before it, and their
reduction to what the per-layer metrics read (device operations in the
window, busy and idle time, the calls' operands) and to the run's
breakdown.

The only annotation inside the window is ``portbench.round``, one a
round.  The wrappers' operands are recorded in a round before the window
opens, since every round makes the same calls, so the traced rounds run
the program with nothing of the benchmark's wrapped around its calls.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
from collections import defaultdict
from typing import NamedTuple, Optional

from portbench import work

PREFIX = "portbench."
ROUND = PREFIX + "round"
#: entries in each list of the breakdown
TOP = 10


class Op(NamedTuple):
    name: str
    start_ns: int
    end_ns: int


def annotate(name: str):
    """A profiler annotation (next to free where no profiler runs)."""
    from torch.autograd.profiler import record_function
    return record_function(PREFIX + name)


class Capture(contextlib.AbstractContextManager):
    """Wrap each ``"module:function"`` target so that every call records
    its tensor arguments' and results' operands under the target's name;
    restore them on exit."""

    def __init__(self, targets):
        self.targets = sorted(set(targets))
        self.calls: dict[str, list] = defaultdict(list)
        self._undo = []

    def _wrap(self, key, fn):
        import torch

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            res = fn(*args, **kwargs)
            outs = res if isinstance(res, (tuple, list)) else (res,)
            self.calls[key].append((
                [work.operand(a) for a in (*args, *kwargs.values())
                 if isinstance(a, torch.Tensor)],
                [work.operand(r) for r in outs
                 if isinstance(r, torch.Tensor)]))
            return res
        return wrapper

    def __enter__(self):
        for key in self.targets:
            mod_name, fn_name = key.split(":")
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, fn_name)
            setattr(mod, fn_name, self._wrap(key, fn))
            self._undo.append((mod, fn_name, fn))
        return self

    def __exit__(self, *exc):
        for mod, fn_name, fn in reversed(self._undo):
            setattr(mod, fn_name, fn)
        self._undo.clear()
        return False


def _kineto_events(prof):
    """(name, on the device, start ns, end ns, kind) of every event."""
    from torch.autograd import DeviceType
    for e in prof.profiler.kineto_results.events():
        start = (e.start_ns() if hasattr(e, "start_ns")
                 else int(e.start_us() * 1000))
        dur = (e.duration_ns() if hasattr(e, "duration_ns")
               else int(e.duration_us() * 1000))
        kind = e.activity_type() if hasattr(e, "activity_type") else ""
        yield (e.name(), e.device_type() == DeviceType.CUDA, int(start),
               int(start + dur), str(kind))


def _merge(ops: list[Op]) -> list[tuple[int, int]]:
    spans: list[list[int]] = []
    for op in sorted(ops, key=lambda o: o.start_ns):
        if spans and op.start_ns <= spans[-1][1]:
            spans[-1][1] = max(spans[-1][1], op.end_ns)
        else:
            spans.append([op.start_ns, op.end_ns])
    return [(a, b) for a, b in spans]


def short_name(name: str) -> str:
    """A device operation's name without ``void`` and its argument list."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    cut = name.find("(")
    return (name[:cut] if cut > 0 else name)[:160]


class Trace:
    """What one traced window holds: ``rounds`` whole rounds between
    ``start_ns`` and ``end_ns`` (the first round's start and the end of the
    last round's work, on the profiler's clock), the device operations inside it,
    the host's events, the calls of one round, and the step that ran."""

    def __init__(self, rounds: int, start_ns: int, end_ns: int,
                 device_ops: list[Op], host_ops: list[Op], calls: dict,
                 step):
        self.rounds, self.start_ns, self.end_ns = rounds, start_ns, end_ns
        self.device_ops, self.host_ops = device_ops, host_ops
        self.calls, self.step = calls, step
        self.busy = _merge(device_ops)

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) / 1e9

    def ops_s(self, pattern=None, exclude=()) -> tuple[float, int]:
        """Seconds and count of the device operations whose name matches
        ``pattern`` (all where None) and none of ``exclude``."""
        total, count = 0, 0
        for op in self.device_ops:
            if pattern is not None and not pattern.search(op.name):
                continue
            if any(p.search(op.name) for p in exclude):
                continue
            total += op.end_ns - op.start_ns
            count += 1
        return total / 1e9, count

    def roofline_pct(self, target: str, pattern, work_fn
                     ) -> Optional[float]:
        """The least time of a round's calls of ``target`` (by ``work_fn``
        over each call's operands) over the device time a round of the
        kernels matching ``pattern``, in percent; None where either is
        absent."""
        calls = self.calls.get(target)
        seconds, count = self.ops_s(pattern)
        if not calls or not count or seconds <= 0:
            return None
        least = sum(work.bound_s(*work_fn(args, results))[0]
                    for args, results in calls)
        return 100.0 * least * self.rounds / seconds

    def gaps(self) -> list[tuple[int, int]]:
        """The idle spans of the window, as (start, end)."""
        out, t = [], self.start_ns
        for a, b in self.busy:
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if self.end_ns > t:
            out.append((t, self.end_ns))
        return out

    def breakdown(self) -> dict:
        """The device operations that took most time, and the idle time by
        the innermost host event running as each gap began, each at most
        TOP entries."""
        by_op: dict[str, int] = defaultdict(int)
        for op in self.device_ops:
            by_op[short_name(op.name)] += op.end_ns - op.start_ns
        by_host: dict[str, int] = defaultdict(int)
        open_ops: list[Op] = []  # the host events running, innermost last
        i = 0
        for a, b in self.gaps():
            while i < len(self.host_ops) and self.host_ops[i].start_ns <= a:
                open_ops.append(self.host_ops[i])
                i += 1
            while open_ops and open_ops[-1].end_ns <= a:
                open_ops.pop()
            host = open_ops[-1].name if open_ops else None
            by_host[{ROUND: "python inside a round", None:
                     "harness between rounds"}.get(host, host)] += b - a
        top = lambda d: [[k, v / 1e9] for k, v in sorted(
            d.items(), key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top(by_op), "idle_gaps": top(by_host)}


def reduce(prof, calls: dict, step) -> Trace:
    """The profile of a window of whole rounds as a :class:`Trace`."""
    rounds, device_ops, host_ops = [], [], []
    for name, on_device, start, end, kind in _kineto_events(prof):
        if on_device:
            if not name.startswith(PREFIX) and "user_annotation" not in kind:
                device_ops.append(Op(name, start, end))
        else:
            host_ops.append(Op(name, start, end))
            if name == ROUND:
                rounds.append((start, end))
    if not rounds:
        raise RuntimeError("the traced window holds no round")
    # the window runs from the first round's start on the host to the end
    # of the last round's work, on the device where the host sent it ahead
    start = min(a for a, _ in rounds)
    end = max([b for _, b in rounds]
              + [op.end_ns for op in device_ops if op.start_ns >= start])
    inside = [Op(op.name, max(op.start_ns, start), min(op.end_ns, end))
              for op in device_ops if op.end_ns > start and op.start_ns < end]
    host_ops.sort(key=lambda op: op.start_ns)
    return Trace(len(rounds), start, end, inside, host_ops, dict(calls),
                 step)
