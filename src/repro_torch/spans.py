"""Profiler ranges around the port's phases.

``span(name)`` is a host range named ``repro_torch.<name>`` while a
``torch.profiler`` session runs, and a shared no-op otherwise: no switch
and no environment variable, so the ranges record exactly when something
profiles (the benchmark's traced run, the ``--profile`` flags).  Inside a
session that also records CUDA activity they are timed on the device
trace's clock.

A range is a function-scope ``RecordFunction`` (what compiled code's
ranges use), not a ``record_function`` user annotation: the profiler
copies each user annotation that encloses kernels onto the device
timeline as one more device event (named as the range, its kind empty in
torch 2.11's CUDA traces), which a reading of the device operations
would count as work.  A function-scope range stays on the host and costs
a few microseconds less.  With no profiler running a span costs one
check.
"""

from __future__ import annotations

import contextlib

import torch

PREFIX = "repro_torch."
_OFF = contextlib.nullcontext()


def span(name: str):
    """A profiler range ``repro_torch.<name>`` where a profiler runs, else
    the shared no-op context."""
    if torch.autograd._profiler_enabled():
        return torch._C._profiler._RecordFunctionFast(PREFIX + name)
    return _OFF
