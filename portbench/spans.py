"""The program's own spans in a traced window, and what the pod
aggregation's readers take from them.

The port records ``repro_torch.<name>`` ranges on the host
(``repro_torch.spans``) where a profiler runs; a port without them
records none, and then every figure here is None.

A device operation belongs to the innermost span open on the host when
the call that put it on the device (a kernel launch, a copy or a fill)
began.  The window's launches and device operations are paired in order:
the rounds run on one stream, so the device runs work in the order it was
launched.  The pairing goes by order alone, not by comparing the two
clocks: the profiler's device timestamps drift against the host's by up
to a millisecond or more over a 30 s window.  Where the counts differ
(the profiler lost a record) there is no pairing.  An idle gap belongs
to the spans open on the host as it began.

This reads only a :class:`portbench.trace.Trace`'s ``host_ops``,
``device_ops``, ``gaps()``, ``start_ns``, ``end_ns`` and ``rounds``.
"""

from __future__ import annotations

import re
from typing import Optional

PREFIX = "repro_torch."
AGGREGATE = PREFIX + "fl_mesh.aggregate"
#: host calls that put one operation on the device: kernel launches by the
#: runtime or the driver API, copies and fills
LAUNCH = re.compile(r"^cu(?:da)?(?:Launch(?:Cooperative)?Kernel\w*"
                    r"|Memcpy\w*|Memset\w*)$")


def program_spans(trace) -> list:
    """The window's program spans, by start (``host_ops`` is sorted)."""
    return [op for op in trace.host_ops if op.name.startswith(PREFIX)
            and trace.start_ns <= op.start_ns < trace.end_ns]


def _open(spans: list, times) -> list[tuple[str, ...]]:
    """For each of the ascending ``times``, the names of the spans open at
    it, outermost first; spans nest on the host."""
    out, stack, i = [], [], 0
    for t in times:
        while i < len(spans) and spans[i].start_ns <= t:
            while stack and stack[-1].end_ns <= spans[i].start_ns:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1].end_ns <= t:
            stack.pop()
        out.append(tuple(op.name for op in stack))
    return out


def launched(trace) -> Optional[list[tuple]]:
    """Each device operation of the window with the innermost program
    span open as its launch began (None where none was), in launch order;
    None without program spans or where launches and operations differ in
    count.  A program span's projection onto the device timeline (which a
    profiler makes of a user annotation) is no operation: no launch made
    it."""
    spans = program_spans(trace)
    if not spans:
        return None
    launches = [op for op in trace.host_ops if LAUNCH.match(op.name)
                and trace.start_ns <= op.start_ns < trace.end_ns]
    ops = sorted((op for op in trace.device_ops
                  if not op.name.startswith(PREFIX)),
                 key=lambda op: op.start_ns)
    if len(launches) != len(ops):
        return None
    owners = _open(spans, [op.start_ns for op in launches])
    return [(op, names[-1] if names else None)
            for op, names in zip(ops, owners)]


def span_device_ms(trace, name: str) -> Optional[float]:
    """Device milliseconds a round of the operations launched inside span
    ``repro_torch.<name>``, none of its children open (None where the
    pairing is)."""
    pairs = launched(trace)
    if pairs is None or not trace.rounds:
        return None
    ns = sum(op.end_ns - op.start_ns for op, owner in pairs
             if owner == PREFIX + name)
    return ns / 1e6 / trace.rounds


def gaps(trace) -> Optional[list[tuple[int, int, tuple[str, ...]]]]:
    """The window's idle gaps as (start, end, the program spans open on
    the host as it began, outermost first); None without program
    spans."""
    spans = program_spans(trace)
    if not spans:
        return None
    found = trace.gaps()
    return [(a, b, names) for (a, b), names
            in zip(found, _open(spans, [a for a, _ in found]))]
