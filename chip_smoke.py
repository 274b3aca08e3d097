#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure exits non-zero:

1. The card (``nvidia-smi`` name and power limit) and the kernel build
   (every ``.cu`` under ``src/repro_torch/kernels``, one ``nvcc`` each, in
   parallel).
2. Each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it and a large one: bitwise equality (and
   with the numpy host path at the main path's shapes), the median of 20
   CUDA-event timings
   after 3 warm-ups, bytes moved, the published-peak bound and the bound
   from a same-size ``copy_`` measured here.
3. The six pinned orchestrator replays over mudp with the fedavg kernel:
   each must reproduce the reference's digest.
4. The main path at full width: 16 clients train the paper's 784-32-10
   MLP for 10 sync rounds over mudp with 10% uplink loss, ``int8(1024)``
   uplinks and FedAvg; then ``Pipeline.encode_batch`` over the clients'
   last updates under the kernel and numpy backends.  Launch counts are
   zeroed just before the rounds and read just after them, so the
   comparison launches of phase 2 and of the ``encode_batch`` check do
   not count.
5. A JSON line with every kernel's numbers, the card line again, and the
   result line ``{"ok": true, "device": {...}}`` last.

It exits non-zero with no result when CUDA is unavailable.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

PEAK_BYTES_PER_S = 3.35e12        # H100 SXM HBM3, NVIDIA data sheet
PEAK_F32_FLOPS = 67e12            # H100 SXM float32 outside tensor cores
SLICE_K, SLICE_N = 16, 25_450     # 16 clients x the 784-32-10 MLP
BLOCK = 1024
# Shapes, by name: "client" is one client's update (the per-client int8
# encode), "batch" the 16 clients' stack (the server's batch decode, the
# FedAvg fold, ``Pipeline.encode_batch``), "large" a 64-335 MB one.
SHAPES = {"fedavg": {"batch": (SLICE_K, SLICE_N), "large": (16, 1 << 24)},
          "quantize": {"client": (1, SLICE_N), "batch": (SLICE_K, SLICE_N),
                       "large": (64, 1 << 20)}}
#: the shape at which each kernel runs on the main path (phase 4)
MAIN_SHAPE = {"fedavg": "batch", "quantize": "client",
              "dequantize": "batch"}
WARMUP, REPS = 3, 20


def say(*parts) -> None:
    print(*parts, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def time_ms(fn) -> float:
    """Median of REPS CUDA-event timings of ``fn()`` after WARMUP calls."""
    import torch
    for _ in range(WARMUP):
        fn()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, calls: int = 20) -> float:
    """Device time of one ``fn()`` without the host's launch cost: ``calls``
    calls captured in one CUDA graph, the graph replayed REPS times, the
    median replay divided by ``calls``."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(WARMUP):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return statistics.median(times)


def bits_equal(a, b) -> bool:
    import torch
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and bool(torch.equal(a, b))


def bound_ms(nbytes: int, flops: int) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# --------------------------------------------------------------------------
def check_kernels():
    import numpy as np
    import torch
    from repro_torch.core import compression
    from repro_torch.kernels.fedavg import ops as fedavg_ops
    from repro_torch.kernels.fedavg import ref as fedavg_ref
    from repro_torch.kernels.quantize import ops as quant_ops
    from repro_torch.kernels.quantize import ref as quant_ref

    dev = torch.device("cuda")
    rows: dict[str, dict[str, dict]] = {}   # name -> shape name -> rec

    def record(name, key, shape, nbytes, flops, kernel_fn, plain_fn, lib_fn,
               err):
        """Time the kernel, its plain version and the library call (if
        any) both ways: per call (host launch included) and on the device
        alone; keep the numbers under rows[name][key]."""
        bnd, by = bound_ms(nbytes, flops)
        n = max(1, nbytes // 2)
        src = torch.empty(n, dtype=torch.uint8, device=dev)
        dst = torch.empty_like(src)
        fns = {"ms": kernel_fn, "plain_ms": plain_fn, "library_ms": lib_fn,
               "copy_ms": lambda: dst.copy_(src)}
        per_call = {k: time_ms(f) if f else None for k, f in fns.items()}
        on_dev = {k: device_ms(f) if f else None for k, f in fns.items()}
        del src, dst

        def fmt(d):
            return ", ".join(f"{k} {v:.6f}" for k, v in d.items()
                             if v is not None)
        say(f"  {name} {shape}: per call: {fmt(per_call)}; device: "
            f"{fmt(on_dev)}; {nbytes} bytes, "
            f"{nbytes / on_dev['ms'] / 1e6:.1f} GB/s on the device, bound "
            f"{bnd:.6f} ms ({by}), max_abs_err {err}")
        rows.setdefault(name, {})[key] = {
            "shape": list(shape), "ms": per_call["ms"],
            "plain_ms": per_call["plain_ms"],
            "library_ms": per_call["library_ms"], "bound_ms": bnd,
            "bound_by": by, "copy_bound_ms": per_call["copy_ms"],
            "bytes": nbytes, "max_abs_err": err, "device": on_dev}

    # -- fedavg --------------------------------------------------------------
    for key, (k, n) in SHAPES["fedavg"].items():
        host_data = key != "large"
        if host_data:
            rng = np.random.default_rng(0)
            stack_np = rng.standard_normal((k, n)).astype(np.float32)
            w_np = (rng.random(k) + 0.5).astype(np.float32)
            w_np = w_np / w_np.sum()
            stack = torch.from_numpy(stack_np).to(dev)
            w = torch.from_numpy(w_np).to(dev)
        else:
            gen = torch.Generator(device=dev).manual_seed(1)
            stack = torch.randn((k, n), generator=gen, device=dev)
            w = torch.rand(k, generator=gen, device=dev) + 0.5
            w = w / w.sum()
        out = fedavg_ops.fedavg(stack, w)
        plain = fedavg_ref.fedavg(stack, w)
        torch.cuda.synchronize()
        if not bits_equal(out, plain):
            raise AssertionError(f"fedavg {k}x{n}: kernel != plain version")
        if host_data:
            acc = np.zeros(n, np.float32)
            for wi, row in zip(w_np, stack_np):
                acc += wi * row
            if not bits_equal(out.cpu(), torch.from_numpy(acc)):
                raise AssertionError("fedavg: kernel != numpy host fold")
        record("fedavg", key, (k, n), 4 * k * n + 4 * k + 4 * n, 2 * k * n,
               lambda: fedavg_ops.fedavg(stack, w),
               lambda: fedavg_ref.fedavg(stack, w),
               lambda: w @ stack, float((out - plain).abs().max()))

    # -- quantize / dequantize -----------------------------------------------
    for key, (r, n) in SHAPES["quantize"].items():
        host_data = key != "large"
        if host_data:
            x_np = np.random.default_rng(2).standard_normal(
                (r, n)).astype(np.float32)
            x = torch.from_numpy(x_np).to(dev)
        else:
            gen = torch.Generator(device=dev).manual_seed(3)
            x = torch.randn((r, n), generator=gen, device=dev)
        nb = -(-n // BLOCK)
        q, s = quant_ops.quantize(x, BLOCK)
        q_ref, s_ref = quant_ref.quantize(x, BLOCK)
        deq = quant_ops.dequantize(q, s, n, BLOCK)
        deq_ref = quant_ref.dequantize(q, s, n, BLOCK)
        torch.cuda.synchronize()
        if not (bits_equal(q, q_ref) and bits_equal(s, s_ref)):
            raise AssertionError(f"quantize {r}x{n}: kernel != plain")
        if not bits_equal(deq, deq_ref):
            raise AssertionError(f"dequantize {r}x{n}: kernel != plain")
        if host_data:
            q_np, s_np = compression.quantize_int8_batch(x_np, BLOCK)
            if not (np.array_equal(q.cpu().numpy(), q_np)
                    and bits_equal(s.cpu(), torch.from_numpy(s_np))):
                raise AssertionError("quantize: kernel != numpy host path")
            d_np = compression.dequantize_int8_batch(q_np, s_np, n, BLOCK)
            if not bits_equal(deq.cpu(), torch.from_numpy(d_np)):
                raise AssertionError("dequantize: kernel != numpy host path")
        qerr = max(float((q.int() - q_ref.int()).abs().max()),
                   float((s - s_ref).abs().max()))
        derr = float((deq - deq_ref).abs().max())
        # quantize reads x and writes every code (padding included) and
        # scale; dequantize reads only the n codes of a row that it
        # expands, and the scales.
        qbytes = 4 * r * n + r * nb * BLOCK + 4 * r * nb
        dbytes = r * n + 4 * r * nb + 4 * r * n
        # quantize: |x|, max, divide, round, two clamps per element; the
        # padded lanes need none of it.  dequantize: one multiply each.
        record("quantize", key, (r, n), qbytes, 6 * r * n,
               lambda: quant_ops.quantize(x, BLOCK),
               lambda: quant_ref.quantize(x, BLOCK), None, qerr)
        record("dequantize", key, (r, n), dbytes, r * n,
               lambda: quant_ops.dequantize(q, s, n, BLOCK),
               lambda: quant_ref.dequantize(q, s, n, BLOCK), None, derr)
    return rows


# --------------------------------------------------------------------------
# Phase 3: pinned replays with the fedavg kernel
# --------------------------------------------------------------------------
def check_digests() -> None:
    from repro_torch import replay
    from repro_torch.core.simulator import PACKET_ENGINES
    for scenario, want in replay.EXPECTED_MUDP.items():
        for engine in PACKET_ENGINES:
            got = replay.run_digest(scenario, "mudp", engine,
                                    aggregation_backend="kernel")
            status = "ok" if got == want else "MISMATCH"
            say(f"  digest {scenario:8s} {engine:10s} {got[:16]} {status}")
            if got != want:
                raise AssertionError(f"digest {scenario}/{engine}: got "
                                     f"{got}, pinned {want}")


# --------------------------------------------------------------------------
# Phase 4: the main path at full width
# --------------------------------------------------------------------------
def run_main_path(rounds: int = 10) -> dict:
    import numpy as np
    import torch
    from repro_torch import fl_mnist, kernels
    from repro_torch.core import wire
    from repro_torch.core.packetizer import flatten_to_vector

    system, model = fl_mnist.build(16, hidden=32, device="cuda")
    acc0 = model.accuracy(system.global_params)
    say(f"  round 0: accuracy {acc0:.4f} ({model.n_params} params, "
        f"data {model.data.source})")
    accs = []
    for r in range(1, rounds + 1):
        t0 = time.perf_counter()
        res = system.run_round()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        acc = model.accuracy(system.global_params)
        accs.append(acc)
        say(f"  round {r}: accuracy {acc:.4f}, arrived {len(res.arrived)}, "
            f"failed {len(res.failed)}, packets {res.packets_sent} sent / "
            f"{res.packets_dropped} dropped, retx {res.retransmissions}, "
            f"wall {wall:.6f} s")
        if res.decode_errors:
            raise AssertionError(f"round {r}: {res.decode_errors} uplinks "
                                 f"failed to decode")
        if len(res.arrived) < 12:
            raise AssertionError(f"round {r}: only {len(res.arrived)} of 16 "
                                 f"clients aggregated")
    if not accs[-1] > acc0:
        raise AssertionError(f"accuracy {accs[-1]} not above round 0 {acc0}")
    if accs[-1] < 0.90:
        raise AssertionError(f"accuracy {accs[-1]} < 0.90 after {rounds} "
                             f"rounds")

    counts = dict(kernels.launch_counts)   # the rounds' launches only
    updates = [flatten_to_vector(c.params)
               for c in system.core.pool.clients.values()]
    pipe = wire.parse_pipeline("int8(1024)")
    kernel_bytes = pipe.encode_batch(updates)
    with wire.using_batch_backend("numpy"):
        numpy_bytes = pipe.encode_batch(updates)
    if kernel_bytes != numpy_bytes:
        raise AssertionError("encode_batch: kernel bytes != numpy bytes")
    say(f"  encode_batch of {len(updates)} updates: "
        f"{sum(map(len, kernel_bytes))} bytes, kernel == numpy")
    if not np.isfinite(np.concatenate(updates)).all():
        raise AssertionError("non-finite parameters after training")
    return counts


def main() -> int:
    import torch

    from repro_torch import kernels
    from repro_torch.kernels import _build
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 1

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_line()
    say(f"[1] card: {card}")
    t0 = time.perf_counter()
    per = _build.build()
    say(f"  built {sorted(per)} in {time.perf_counter() - t0:.3f} s "
        f"(per source: {json.dumps({k: round(v, 3) for k, v in per.items()})})")
    for name in sorted(per):
        log = _build.BUILD_DIR / f"{name}.log"
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    say(f"  ptxas {name}: {line.strip()}")

    say("[2] kernels against their plain versions")
    rows = check_kernels()

    say("[3] pinned replays with the fedavg kernel")
    check_digests()

    say("[4] main path: 16 clients, MLP 784-32-10, mudp, int8(1024), fedavg")
    kernels.reset_launch_counts()
    counts = run_main_path()
    say(f"  launch counts: {json.dumps(counts)}")
    for name in ("fedavg", "quantize", "dequantize"):
        if counts.get(name, 0) <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"main path")

    sources = {"fedavg": "src/repro_torch/kernels/fedavg/csrc/fedavg.cu",
               "quantize": "src/repro_torch/kernels/quantize/csrc/quantize.cu",
               "dequantize":
                   "src/repro_torch/kernels/quantize/csrc/quantize.cu"}
    replaces = {"fedavg": "src/repro/kernels/fedavg/fedavg.py:32",
                "quantize": "src/repro/kernels/quantize/quantize.py:40",
                "dequantize": "src/repro/kernels/quantize/quantize.py:68"}
    out = []
    for name in ("fedavg", "quantize", "dequantize"):
        rec = rows[name][MAIN_SHAPE[name]]
        out.append({"name": name, "route": "cuda", "source": sources[name],
                    "replaces": replaces[name], "launches": counts[name],
                    "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                    "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                    "bound_by": rec["bound_by"],
                    "library_ms": rec["library_ms"], "shape": rec["shape"],
                    "bytes": rec["bytes"],
                    "copy_bound_ms": rec["copy_bound_ms"],
                    "device": rec["device"],
                    "other_shapes": {key: r for key, r in rows[name].items()
                                     if key != MAIN_SHAPE[name]}})
    say(f"  total {time.perf_counter() - t_start:.3f} s")
    say(json.dumps({"kernels": out}))
    say(card_line())
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
