"""The payload codecs on the port: the paper's Algorithm I hex against the
production codecs.

The counterpart of the reference's ``benchmarks/codecs.py``: encode and
decode of a 1,000,000-parameter float32 vector (``default_rng(0)``)
through each of ``hex``, ``raw``, ``int8`` and ``topk``
(:func:`repro_torch.core.compression.make_codec`), three times.  Each row
gives the wall of one encode + decode, the wire bytes per parameter and
the largest reconstruction error (``nan`` for ``topk``, which drops
values by design).  The legacy codecs are host numpy, as the reference's,
so this suite launches no kernel.

    PYTHONPATH=src python -m repro_torch.bench_run --device cpu --only codecs
"""

from __future__ import annotations

import time

import numpy as np

from repro_torch.core.compression import make_codec


def bench():
    """``(row name, wall us, derived fields)``, as the reference's
    ``bench()``."""
    rng = np.random.default_rng(0)
    vec = rng.standard_normal(1_000_000).astype(np.float32)
    rows = []
    for name in ("hex", "raw", "int8", "topk"):
        codec = make_codec(name)
        t0 = time.perf_counter()
        reps = 3
        for _ in range(reps):
            data = codec.encode(vec)
            out = codec.decode(data)
        us = (time.perf_counter() - t0) * 1e6 / reps
        err = (float(np.abs(out[:vec.size] - vec).max()) if name != "topk"
               else float("nan"))
        rows.append((f"codecs/{name}", us,
                     f"bytes_per_param={len(data) / vec.size:.2f}"
                     f";max_err={err:.2e}"))
    return rows
