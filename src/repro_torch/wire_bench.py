"""The wire plane's pipelines on the port: encode/decode throughput,
compression ratio and the determinism gate.

The counterpart of the reference's ``benchmarks/wire_bench.py``.  For each
spec of :data:`SPECS`: encode and self-describing decode of a
``--params``-long float32 vector (``default_rng(0)``), with wall time per
direction, MB/s of input, wire bytes per parameter and the largest
reconstruction error (delta-domain specs against a zero reference).  The
``int8`` and ``topk`` stages run on the device (quantize, dequantize, the
top-k gather and scatter: one row of ``--params`` a call).  Then the batch
sweep: :data:`BATCH_SPECS` over 1 / 16 / 64 / 256 clients at 256
parameters, the batch plane (``encode_batch`` / ``decode_payload_batch``)
against the per-client loop, under each wire backend (``"numpy"``, the
host codec, and ``"kernel"``, the device's kernels at (N, 256)).

``--check`` exits 1 unless every gate holds:

* determinism, under both backends: two independently built pipelines
  give the same wire bytes, whose SHA-256 equals the reference's at
  ``--params 250000`` (:data:`PINS`), and the header-only decode equals
  the out-of-band decode bit for bit;
* the batch bytes equal the loop's at every point, under both backends;
* the reference's floor: the ``"numpy"`` batch plane at least 4x the loop
  (encode + decode) at 256 clients for one spec.  The ``"kernel"``
  backend's speedup is reported, not held.

The report goes to ``--out`` when given.

    PYTHONPATH=src python -m repro_torch.wire_bench --device cpu --check \\
        --params 250000
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time

import numpy as np

from repro_torch import device as _device
from repro_torch.core.wire import (WIRE_BATCH_BACKENDS, decode_payload,
                                   decode_payload_batch, parse_pipeline,
                                   using_batch_backend)

#: The spec matrix: the four legacy codecs as single-stage pipelines plus
#: the compositions the FL layer ships.
SPECS = (
    "raw",
    "hex",
    "int8(1024)",
    "topk(0.01)",
    "delta|ef|int8(1024)",
    "delta|ef|topk(0.01)|int8(1024)",
    "topk(0.01)|int8(256)",
)
BATCH_SPECS = (
    "int8(1024)",
    "topk(0.01)|int8(256)",
    "delta|ef|topk(0.01)|int8(1024)",
)
BATCH_CLIENTS = (1, 16, 64, 256)
BATCH_PARAMS = 256
#: The reference's floor, held on the numpy backend as the reference
#: holds it: the batch plane's encode + decode speedup at 256 clients.
BATCH_GATE_CLIENTS = 256
BATCH_GATE_SPEEDUP = 4.0
BATCH_GATE_BACKEND = "numpy"


def _fresh_state(pipeline, vec):
    state = pipeline.new_state()
    if pipeline.caps.delta_domain:
        pipeline.set_reference(state, np.zeros_like(vec))
    return state


def _bench_spec(spec: str, vec: np.ndarray, repeats: int) -> dict:
    pipeline = parse_pipeline(spec)
    # Bytes, ratio and error come from one encode on fresh state, so the
    # report does not depend on --repeats.
    data = pipeline.encode(vec, _fresh_state(pipeline, vec))
    out, _ = decode_payload(data)

    t0 = time.perf_counter()
    for _ in range(repeats):
        pipeline.encode(vec, _fresh_state(pipeline, vec))
    enc_s = (time.perf_counter() - t0) / repeats

    t0 = time.perf_counter()
    for _ in range(repeats):
        decode_payload(data)
    dec_s = (time.perf_counter() - t0) / repeats

    in_bytes = vec.size * 4
    return {
        "spec": pipeline.spec,
        "caps": {
            "lossless": pipeline.caps.lossless,
            "stateful": pipeline.caps.stateful,
            "delta_domain": pipeline.caps.delta_domain,
            "est_ratio": pipeline.caps.est_ratio,
        },
        "n_params": int(vec.size),
        "wire_bytes": len(data),
        "wire_sha256": hashlib.sha256(data).hexdigest(),
        "bytes_per_param": len(data) / vec.size,
        "measured_ratio": len(data) / in_bytes,
        "encode_us": enc_s * 1e6,
        "decode_us": dec_s * 1e6,
        "encode_mb_s": in_bytes / enc_s / 1e6,
        "decode_mb_s": in_bytes / dec_s / 1e6,
        "max_abs_err": float(np.abs(out - vec).max()),
    }


def wire_hashes(vec: np.ndarray) -> tuple[dict[str, str], list[str]]:
    """Each spec's wire-byte SHA-256 on fresh state, and the determinism
    failures: bytes differing across two constructions, or a header-only
    decode differing from the out-of-band one."""
    hashes, failures = {}, []
    for spec in SPECS:
        digests = []
        for _ in range(2):
            p = parse_pipeline(spec)
            data = p.encode(vec, _fresh_state(p, vec))
            negotiated, _ = decode_payload(data)
            oob = p.decode(data, p.new_state())
            if negotiated.tobytes() != oob.tobytes():
                failures.append(f"{spec}: header-only decode != out-of-band")
            digests.append(hashlib.sha256(data).hexdigest())
        if digests[0] != digests[1]:
            failures.append(f"{spec}: wire bytes differ across constructions")
        hashes[spec] = digests[0]
    return hashes, failures


def _bench_batch_point(pipeline, vecs, repeats: int) -> dict:
    """One (spec, clients) point, loop against batch, each the best of
    three timed blocks."""
    n_clients = len(vecs)
    needs_state = pipeline.caps.stateful or pipeline.caps.delta_domain

    def states():
        return [_fresh_state(pipeline, vecs[0]) for _ in range(n_clients)]

    def loop_once():
        if not needs_state:
            datas = [pipeline.encode(v) for v in vecs]
        else:
            datas = [pipeline.encode(v, s) for v, s in zip(vecs, states())]
        for d in datas:
            decode_payload(d)
        return datas

    def batch_once():
        datas = (pipeline.encode_batch(vecs) if not needs_state
                 else pipeline.encode_batch(vecs, states()))
        decode_payload_batch(datas)
        return datas

    def best_of(fn, trials=3):
        best = float("inf")
        for _ in range(trials):
            t0 = time.perf_counter()
            for _ in range(repeats):
                fn()
            best = min(best, (time.perf_counter() - t0) / repeats)
        return best

    loop_bytes, batch_bytes = loop_once(), batch_once()   # warm + parity
    loop_s = best_of(loop_once)
    batch_s = best_of(batch_once)
    in_mb = n_clients * vecs[0].size * 4 / 1e6
    return {
        "n_clients": n_clients,
        "loop_us": loop_s * 1e6,
        "batch_us": batch_s * 1e6,
        "loop_mb_s": in_mb / loop_s,
        "batch_mb_s": in_mb / batch_s,
        "speedup": loop_s / batch_s,
        "bytes_identical": batch_bytes == loop_bytes,
    }


def run_batch_sweep(repeats: int) -> list[dict]:
    """The batch sweep over :data:`BATCH_CLIENTS`."""
    rng = np.random.default_rng(0)
    out = []
    for spec in BATCH_SPECS:
        pipeline = parse_pipeline(spec)
        points = []
        for n_clients in BATCH_CLIENTS:
            vecs = [rng.standard_normal(BATCH_PARAMS).astype(np.float32)
                    for _ in range(n_clients)]
            points.append(_bench_batch_point(pipeline, vecs, repeats))
        out.append({"spec": pipeline.spec, "n_params": BATCH_PARAMS,
                    "points": points})
    return out


def _batch_failures(backend: str, sweep: list[dict]) -> list[str]:
    """Parity everywhere; on the gate backend, the floor at the gate point
    for at least one spec."""
    failures, best = [], 0.0
    for entry in sweep:
        for pt in entry["points"]:
            if not pt["bytes_identical"]:
                failures.append(f"{backend}: {entry['spec']} @N="
                                f"{pt['n_clients']}: batch bytes != loop "
                                f"bytes")
            if pt["n_clients"] == BATCH_GATE_CLIENTS:
                best = max(best, pt["speedup"])
    if backend == BATCH_GATE_BACKEND and best < BATCH_GATE_SPEEDUP:
        failures.append(f"{backend}: batch speedup at {BATCH_GATE_CLIENTS} "
                        f"clients is {best:.2f}x (< {BATCH_GATE_SPEEDUP:.1f}x "
                        f"gate)")
    return failures


#: The reference's wire-byte SHA-256 of each spec at --params 250000.
PINNED_PARAMS = 250_000
PINS = {
    "raw":
        "826fb7b7540e361d1522beb9fb10cc0b65caf8c69c6ff257"
        "7d046c750fa67d0c",
    "hex":
        "6e31a4dcf03fa04bdd36655959d61801785d0002b369ed01"
        "2de1b67fbb540649",
    "int8(1024)":
        "3548c2f7721860dd64efd4951e0bff27d0b5677e4da84a33"
        "64872a50dc48e04c",
    "topk(0.01)":
        "4c82f9abcab457463f2eb36d9d6f825daf6b7cd0d87f33c8"
        "3d1cb55c858fb7d9",
    "delta|ef|int8(1024)":
        "1310bb13cde5cfb51ffe36015327f846b50969e4cecd6023"
        "5d3021c4f49c2ce2",
    "delta|ef|topk(0.01)|int8(1024)":
        "b04f31191b4d6dd7014e9d6a88773d7fc111156516e22ff8"
        "92cafe9a4ccd770b",
    "topk(0.01)|int8(256)":
        "68c3d7a026f4d3737fe845b7b1118d7265af71d3c793f981"
        "a847147013d9d71f",
}


def run(n_params: int, repeats: int) -> tuple[dict, list[str]]:
    """The benchmark: ``(report, gate failures)``."""
    rng = np.random.default_rng(0)
    vec = rng.standard_normal(n_params).astype(np.float32)
    report: dict = {"n_params": n_params, "repeats": repeats,
                    "batch_sweep": {}, "wire_sha256": {}}
    failures: list[str] = []
    for backend in WIRE_BATCH_BACKENDS:
        with using_batch_backend(backend):
            hashes, fail = wire_hashes(vec)
            sweep = run_batch_sweep(repeats)
        report["wire_sha256"][backend] = hashes
        report["batch_sweep"][backend] = sweep
        failures += [f"{backend}: {m}" for m in fail]
        failures += _batch_failures(backend, sweep)
        if n_params == PINNED_PARAMS:
            failures += [f"{backend}: {spec}: wire bytes {h} != pinned "
                         f"{PINS[spec]}" for spec, h in hashes.items()
                         if h != PINS[spec]]
    report["pipelines"] = [_bench_spec(s, vec, repeats) for s in SPECS]
    report["pinned"] = n_params == PINNED_PARAMS
    report["failures"] = failures
    return report, failures


def bench():
    """``(row name, wall us, derived fields)``, as the reference's
    ``bench()`` (1,000,000 parameters, 3 repeats).  The batch rows are
    the ``"kernel"`` backend's, the one the main path runs;
    ``wire/determinism`` reads ``ok`` exactly when :func:`run` finds no
    failure under either backend."""
    report, failures = run(n_params=1_000_000, repeats=3)
    rows = []
    for p in report["pipelines"]:
        rows.append((
            f"wire/{p['spec']}",
            p["encode_us"] + p["decode_us"],
            f"bytes_per_param={p['bytes_per_param']:.3f}"
            f";enc_mb_s={p['encode_mb_s']:.0f}"
            f";dec_mb_s={p['decode_mb_s']:.0f}",
        ))
    for entry in report["batch_sweep"]["kernel"]:
        gate_pt = entry["points"][-1]
        rows.append((
            f"wire_batch/{entry['spec']}@{gate_pt['n_clients']}",
            gate_pt["batch_us"],
            f"speedup={gate_pt['speedup']:.2f}x"
            f";batch_mb_s={gate_pt['batch_mb_s']:.0f}"
            f";bytes_identical={gate_pt['bytes_identical']}",
        ))
    rows.append(("wire/determinism", 0.0,
                 "ok" if not failures else ";".join(failures)))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--params", type=int, default=1_000_000)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--out", default=None, help="write the JSON report here")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 if a gate fails")
    args = ap.parse_args(argv)
    with _device.use_device(_device.resolve(args.device)):
        report, failures = run(args.params, args.repeats)
    for p in report["pipelines"]:
        print(f"{p['spec']:34s} {p['bytes_per_param']:7.3f} B/param  "
              f"enc {p['encode_mb_s']:8.0f} MB/s  "
              f"dec {p['decode_mb_s']:8.0f} MB/s  "
              f"max_err {p['max_abs_err']:.2e}")
    for backend, sweep in report["batch_sweep"].items():
        print(f"\nbatch plane, {backend} backend (P={BATCH_PARAMS}, "
              f"encode+decode, batch vs loop):")
        for entry in sweep:
            cells = "  ".join(f"N={pt['n_clients']:<3d} {pt['speedup']:5.2f}x"
                              for pt in entry["points"])
            print(f"{entry['spec']:34s} {cells}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
        print(f"wrote {args.out}")
    for fail in failures:
        print(f"WIRE GATE FAILURE: {fail}", file=sys.stderr)
    if args.check and not failures:
        print(f"determinism check: ok{' (pinned)' if report['pinned'] else ''}"
              f"; batch gate: ok (>= {BATCH_GATE_SPEEDUP:.0f}x at "
              f"{BATCH_GATE_CLIENTS} clients, {BATCH_GATE_BACKEND} backend)")
    return 1 if args.check and failures else 0


if __name__ == "__main__":
    sys.exit(main())
