#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure exits non-zero:

1. The card (``nvidia-smi`` name and power limit) and the kernel build
   (every ``.cu`` under ``src/repro_torch/kernels``, one ``nvcc`` each, in
   parallel).
2. Each kernel against its plain PyTorch version on the card, at the
   shapes the main paths give it and a large one: bitwise equality (and
   with the numpy host path at the main paths' shapes), the median of 20
   CUDA-event timings of one wrapper call after 3 warm-ups, the device
   time alone (20 launches in one CUDA graph), bytes moved, the
   published-peak bound and the bound from a same-size ``copy_``
   measured here, and the time of one PyTorch call computing the same
   function where there is one.
3. The 24 pinned orchestrator replays (6 scenarios x mudp, udp, tcp,
   mudp+fec) under both packet engines with the fedavg kernel: each must
   reproduce the reference's digest.
4. Slice 1's path at full width: 16 clients train the paper's 784-32-10
   MLP for 10 sync rounds over mudp with 10% uplink loss, ``int8(1024)``
   uplinks and FedAvg; then ``Pipeline.encode_batch`` over the clients'
   last updates under the kernel and numpy backends.
5. The adaptive fleet path at full width (``repro_torch.fleet_sim``): 48
   clients in fiber / lte / congested-edge cohorts train the MLP for 10
   sync rounds over ``mudp+fec`` with a ``delta|ef|topk(0.15)|int8(1024)``
   uplink, a 4 s round deadline and the adaptive control ladder.  Every
   round must reproduce the reference's pinned arrivals, late folds,
   retransmissions and tier counts.  Then the checksum kernel runs over
   every uplink body the server decoded in that run, against the numpy
   ChunkSum-32.
6. A JSON line with every kernel's numbers, the card line again, and the
   result line ``{"ok": true, "device": {...}}`` last.

Launch counts are zeroed just before each path (phases 4, 5 and the
checksum pass of 5) and read just after it, so the comparison launches of
phase 2 and of the ``encode_batch`` check do not count.

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
# The adaptive path's top-k shapes, (rows, dense width, kept): one
# client's row at each tier of the ladder (topk(0.4), (0.15), (0.04) of
# 25,450), which every client's encode gathers and its EF residual decode
# scatters; the server's batch decode of a tier-0 and a tier-2 group; a
# large one at 15% density.
TIER_K = {"t0": 10_180, "t1": 3817, "t2": 1018}
CLIENT_SHAPES = {f"client_{t}": (1, SLICE_N, k) for t, k in TIER_K.items()}
TOPK_SHAPES = {
    "topk_gather": dict(CLIENT_SHAPES, large=(64, 1 << 20, 157_286)),
    "topk_scatter": dict(CLIENT_SHAPES, group_t0=(18, SLICE_N, 10_180),
                         group_t2=(25, SLICE_N, 1018),
                         large=(64, 1 << 20, 157_286))}
CHECKSUM_LARGE = 256 << 20               # bytes
FLEET_ROUNDS = 10
#: the shape at which each kernel runs most often on its path (phases 4
#: and 5; phase 5 prints the top-k kernels' calls by shape)
MAIN_SHAPE = {"fedavg": "batch", "quantize": "client",
              "dequantize": "batch", "topk_gather": "client_t2",
              "topk_scatter": "client_t2", "checksum": "uplink"}
SOURCES = {"fedavg": "src/repro_torch/kernels/fedavg/csrc/fedavg.cu",
           "quantize": "src/repro_torch/kernels/quantize/csrc/quantize.cu",
           "dequantize": "src/repro_torch/kernels/quantize/csrc/quantize.cu",
           "topk_gather": "src/repro_torch/kernels/topk/csrc/topk.cu",
           "topk_scatter": "src/repro_torch/kernels/topk/csrc/topk.cu",
           "checksum": "src/repro_torch/kernels/checksum/csrc/checksum.cu"}
REPLACES = {"fedavg": "src/repro/kernels/fedavg/fedavg.py:32",
            "quantize": "src/repro/kernels/quantize/quantize.py:40",
            "dequantize": "src/repro/kernels/quantize/quantize.py:68",
            "topk_gather": "src/repro/kernels/topk/topk.py:48",
            "topk_scatter": "src/repro/kernels/topk/topk.py:67",
            "checksum": "src/repro/kernels/checksum/checksum.py:50"}
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
               err, launch_fn=None):
        """Time the kernel, its plain version and the library call (if
        any) both ways: per call (host launch included) and on the device
        alone; keep the numbers under rows[name][key].  ``launch_fn``,
        where given, is the bare launch into preallocated buffers that
        the device timing captures in place of the wrapper (whose read of
        the kernel's bad-index flag waits for the host)."""
        bnd, by = bound_ms(nbytes, flops)
        n = max(1, nbytes // 2)
        src = torch.empty(n, dtype=torch.uint8, device=dev)
        dst = torch.empty_like(src)
        fns = {"ms": kernel_fn, "plain_ms": plain_fn, "library_ms": lib_fn,
               "copy_ms": lambda: dst.copy_(src)}
        per_call = {k: time_ms(f) if f else None for k, f in fns.items()}
        on_dev = {k: device_ms(f) if f else None
                  for k, f in dict(fns, ms=launch_fn or kernel_fn).items()}
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

    check_topk(dev, record)
    check_checksum(dev, record)
    return rows


def _topk_inputs(dev, key, rows, n, k, seed):
    """(values (rows, n) f32, sorted distinct int32 indices (rows, k)):
    at the main paths' shapes on the host from numpy, the way the wire
    plane selects them (largest |x|), at the large shape on the card."""
    import numpy as np
    import torch
    if key != "large":
        x_np = np.random.default_rng(seed).standard_normal(
            (rows, n)).astype(np.float32)
        idx_np = np.sort(np.argpartition(np.abs(x_np), -k, axis=1)[:, -k:],
                         axis=1).astype(np.int32)
        return (torch.from_numpy(x_np).to(dev),
                torch.from_numpy(idx_np).to(dev), x_np, idx_np)
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((rows, n), generator=gen, device=dev)
    idx = torch.sort(torch.topk(x.abs(), k, dim=1).indices, dim=1).values
    return x, idx.to(torch.int32).contiguous(), None, None


def check_topk(dev, record) -> None:
    """Phase 2 for the top-k gather and scatter kernels."""
    import numpy as np
    import torch
    from repro_torch.kernels.topk import ops as topk_ops
    from repro_torch.kernels.topk import ref as topk_ref

    for key, (rows, n, k) in TOPK_SHAPES["topk_gather"].items():
        x, idx, x_np, idx_np = _topk_inputs(dev, key, rows, n, k, 4)
        out = topk_ops.topk_gather(x, idx)
        plain = topk_ref.gather(x, idx)
        torch.cuda.synchronize()
        if not bits_equal(out, plain):
            raise AssertionError(f"topk_gather {rows}x{n}->{k}: kernel != "
                                 f"plain version")
        if x_np is not None and not bits_equal(out.cpu(), torch.from_numpy(
                np.take_along_axis(x_np, idx_np.astype(np.int64), axis=1))):
            raise AssertionError("topk_gather: kernel != numpy host path")
        idx64 = idx.long()
        buf = torch.empty_like(out)
        err = torch.empty(1, dtype=torch.int32, device=dev)
        # Reads idx and the kept values of x, writes the kept values.
        record("topk_gather", key, (rows, n, k), 12 * rows * k, 0,
               lambda: topk_ops.topk_gather(x, idx),
               lambda: topk_ref.gather(x, idx),
               lambda: torch.gather(x, 1, idx64),
               float((out - plain).abs().max()),
               launch_fn=lambda: topk_ops._launch_gather(x, idx, buf, err))

    for key, (rows, n, k) in TOPK_SHAPES["topk_scatter"].items():
        x, idx, x_np, idx_np = _topk_inputs(dev, key, rows, n, k, 5)
        vals = torch.gather(x, 1, idx.long()).contiguous()
        out = topk_ops.topk_scatter(idx, vals, n)
        plain = topk_ref.scatter(idx, vals, n)
        torch.cuda.synchronize()
        if not bits_equal(out, plain):
            raise AssertionError(f"topk_scatter {rows}x{k}->{n}: kernel != "
                                 f"plain version")
        if x_np is not None:
            dense = np.zeros((rows, n), np.float32)
            np.put_along_axis(dense, idx_np.astype(np.int64),
                              vals.cpu().numpy(), axis=1)
            if not bits_equal(out.cpu(), torch.from_numpy(dense)):
                raise AssertionError("topk_scatter: kernel != numpy host "
                                     "path")
        idx64 = idx.long()
        buf = torch.empty_like(out)
        err = torch.empty(1, dtype=torch.int32, device=dev)
        # Reads idx and vals, writes the whole dense output.
        record("topk_scatter", key, (rows, k, n),
               4 * rows * n + 8 * rows * k, 0,
               lambda: topk_ops.topk_scatter(idx, vals, n),
               lambda: topk_ref.scatter(idx, vals, n),
               lambda: torch.zeros((rows, n), device=dev).scatter_(
                   1, idx64, vals),
               float((out - plain).abs().max()),
               launch_fn=lambda: topk_ops._launch_scatter(
                   idx, vals, buf, err))

    # Duplicate indices resolve last-wins, like the reference's loop.
    dup = torch.tensor([[3, 3, 7], [0, 5, 0]], dtype=torch.int32, device=dev)
    dvals = torch.tensor([[1., 2., 3.], [4., 5., 6.]], device=dev)
    want = torch.zeros((2, 10))
    want[0, 3], want[0, 7], want[1, 0], want[1, 5] = 2., 3., 6., 5.
    got = topk_ops.topk_scatter(dup, dvals, 10).cpu()
    if not (bits_equal(got, want)
            and bits_equal(topk_ref.scatter(dup, dvals, 10).cpu(), want)):
        raise AssertionError(f"topk_scatter duplicates: got {got.tolist()}")
    # Unordered rows with many duplicates over several column chunks, beside
    # increasing rows in the same call, against numpy's sequential writes.
    rng = np.random.default_rng(8)
    mixed = rng.integers(0, 30_000, (6, 5000)).astype(np.int32)
    for r in range(0, 6, 2):                         # strictly increasing
        mixed[r] = np.sort(rng.choice(30_000, 5000, replace=False))
    mvals = rng.standard_normal((6, 5000)).astype(np.float32)
    dense = np.zeros((6, 30_000), np.float32)
    dense[np.repeat(np.arange(6), 5000), mixed.reshape(-1)] = \
        mvals.reshape(-1)
    got = topk_ops.topk_scatter(torch.from_numpy(mixed).to(dev),
                                torch.from_numpy(mvals).to(dev), 30_000)
    if not bits_equal(got.cpu(), torch.from_numpy(dense)):
        raise AssertionError("topk_scatter: unordered rows != numpy")
    say("  topk_scatter with duplicate indices: last-wins, kernel == plain "
        "== numpy")


def uplink_body() -> bytes:
    """One real adaptive-path uplink: a seeded update through the tier-1
    pipeline (delta, error feedback, topk(0.15), int8(1024))."""
    import numpy as np
    from repro_torch import fleet_sim
    from repro_torch.core import wire
    pipe = wire.parse_pipeline(fleet_sim.UPLINK)
    vec = np.random.default_rng(6).standard_normal(SLICE_N).astype(
        np.float32)
    with wire.using_batch_backend("numpy"):
        return pipe.encode(vec, pipe.new_state())


def check_checksum(dev, record) -> None:
    """Phase 2 for the ChunkSum-32 kernel."""
    import numpy as np
    import torch
    from repro_torch.core import wire
    from repro_torch.kernels.checksum import ops as ck_ops
    from repro_torch.kernels.checksum import ref as ck_ref

    body = uplink_body()
    gen = torch.Generator(device=dev).manual_seed(7)
    inputs = {"uplink": torch.from_numpy(
                  np.frombuffer(body, np.uint8).copy()).to(dev),
              "large": torch.randint(0, 256, (CHECKSUM_LARGE,),
                                     generator=gen, dtype=torch.uint8,
                                     device=dev)}
    for key, x in inputs.items():
        sums = ck_ops.chunksum32(x)
        plain = ck_ref.chunksum32(x)
        torch.cuda.synchronize()
        if not bits_equal(sums, plain):
            raise AssertionError(f"checksum over {x.numel()} bytes: kernel "
                                 f"{sums.tolist()} != plain {plain.tolist()}")
        if key == "uplink" and ck_ref.combine(sums) != wire.chunksum32(body):
            raise AssertionError("checksum: kernel != numpy chunksum32")
        # Reads every byte once; two integer multiply-adds a byte are far
        # under the card's integer rate, so the bound is the bytes.
        record("checksum", key, (x.numel(),), x.numel(), 0,
               lambda: ck_ops.chunksum32(x),
               lambda: ck_ref.chunksum32(x), None,
               float((sums.long() - plain.long()).abs().max()))


# --------------------------------------------------------------------------
# Phase 3: pinned replays with the fedavg kernel
# --------------------------------------------------------------------------
def check_digests() -> None:
    from repro_torch import replay
    from repro_torch.core.simulator import PACKET_ENGINES
    for (scenario, kind), want in replay.EXPECTED.items():
        for engine in PACKET_ENGINES:
            got = replay.run_digest(scenario, kind, engine,
                                    aggregation_backend="kernel")
            status = "ok" if got == want else "MISMATCH"
            say(f"  digest {scenario:8s} {kind:8s} {engine:10s} {got[:16]} "
                f"{status}")
            if got != want:
                raise AssertionError(f"digest {scenario}/{kind}/{engine}: "
                                     f"got {got}, pinned {want}")


# --------------------------------------------------------------------------
# Phase 4: slice 1's path at full width
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


# --------------------------------------------------------------------------
# Phase 5: the adaptive fleet path at full width
# --------------------------------------------------------------------------
def run_fleet_path() -> tuple[dict, list[bytes], dict]:
    """Drive ``repro_torch.fleet_sim``'s adaptive MLP arm; returns the
    path's launch counts, every uplink body the server decoded, and the
    top-k wrappers' calls by shape (``"rows x width -> kept"``)."""
    import collections

    import numpy as np
    from repro_torch import fleet_sim, kernels
    from repro_torch.core import server
    from repro_torch.kernels.topk import ops as topk_ops

    bodies: list[bytes] = []
    by_shape = {"topk_gather": collections.Counter(),
                "topk_scatter": collections.Counter()}
    decode = server.wire_decode_payload_batch
    gather, scatter = topk_ops.topk_gather, topk_ops.topk_scatter

    def capture(datas, *args, **kwargs):
        bodies.extend(bytes(d) for d in datas)
        return decode(datas, *args, **kwargs)

    def shaped_gather(x, idx):
        by_shape["topk_gather"][
            f"{x.shape[0]}x{x.shape[1]}->{idx.shape[1]}"] += 1
        return gather(x, idx)

    def shaped_scatter(idx, vals, n):
        by_shape["topk_scatter"][f"{idx.shape[0]}x{n}->{idx.shape[1]}"] += 1
        return scatter(idx, vals, n)

    server.wire_decode_payload_batch = capture
    topk_ops.topk_gather, topk_ops.topk_scatter = (shaped_gather,
                                                   shaped_scatter)
    try:
        kernels.reset_launch_counts()
        build = fleet_sim.build("mudp+fec", model="mlp", control="adaptive",
                                device="cuda")
        records = fleet_sim.run_rounds(build, FLEET_ROUNDS)
        counts = dict(kernels.launch_counts)
    finally:
        server.wire_decode_payload_batch = decode
        topk_ops.topk_gather, topk_ops.topk_scatter = gather, scatter
    head = records[0]
    say(f"  cohorts {head['cohorts']}, {build.model.n_params} params, "
        f"round 0: accuracy {head['accuracy']:.4f}")
    for rec, pin in zip(records[1:], fleet_sim.PINNED_ADAPTIVE):
        r = rec["round"]
        say(f"  round {r}: accuracy {rec['accuracy']:.4f}, arrived "
            f"{rec['arrived']}, late_folded {rec['late_folded']}, retx "
            f"{rec['retransmissions']}, tiers {rec['tiers']}, "
            f"{rec['bytes_sent']} bytes, wall {rec['wall_s']:.6f} s")
        got = {k: rec[k] for k in pin}
        if got != pin:
            raise AssertionError(f"round {r}: {got} != pinned {pin}")
        if rec["decode_errors"]:
            raise AssertionError(f"round {r}: {rec['decode_errors']} "
                                 f"uplinks failed to decode")
        if r >= 2 and min(rec["tiers"]) == 0:
            raise AssertionError(f"round {r}: a tier is empty: "
                                 f"{rec['tiers']}")
    if len(records) != FLEET_ROUNDS + 1:
        raise AssertionError(f"{len(records) - 1} rounds ran")
    acc0, acc = head["accuracy"], records[-1]["accuracy"]
    if not (acc > acc0 and acc >= 0.90):
        raise AssertionError(f"accuracy {acc} after {FLEET_ROUNDS} rounds "
                             f"(round 0: {acc0}); need >= 0.90 and above "
                             f"round 0")
    params = np.concatenate([np.ravel(v) for v in
                             build.system.global_params.values()])
    if not np.isfinite(params).all():
        raise AssertionError("non-finite global parameters")
    walls = [rec["wall_s"] for rec in records[1:]]
    say(f"  {records[-1]['renegotiations']} renegotiations; round wall "
        f"median {statistics.median(walls):.6f} s, first {walls[0]:.6f} s")
    by_shape = {name: dict(c.most_common()) for name, c in by_shape.items()}
    for name, calls in by_shape.items():
        say(f"  {name} calls by shape: {json.dumps(calls)}")
    return counts, bodies, by_shape


def run_checksum_path(bodies: list[bytes]) -> dict:
    """ChunkSum-32 of every captured uplink body on the card, against the
    wire plane's numpy ChunkSum-32; returns the pass's launch counts."""
    from repro_torch import kernels
    from repro_torch.core import wire
    from repro_torch.kernels.checksum import ops as ck_ops

    if not bodies:
        raise AssertionError("the fleet path decoded no uplink bodies")
    kernels.reset_launch_counts()
    for body in bodies:
        got = ck_ops.checksum_bytes(body, device="cuda")
        if got != wire.chunksum32(body):
            raise AssertionError(f"checksum of a {len(body)}-byte body: "
                                 f"kernel {got} != numpy "
                                 f"{wire.chunksum32(body)}")
    counts = dict(kernels.launch_counts)
    say(f"  {len(bodies)} uplink bodies ({sum(map(len, bodies))} bytes): "
        f"kernel == numpy chunksum32")
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

    say("[3] pinned replays (4 transports x 6 scenarios x 2 engines) with "
        "the fedavg kernel")
    check_digests()

    say("[4] slice 1's path: 16 clients, MLP 784-32-10, mudp, int8(1024), "
        "fedavg")
    kernels.reset_launch_counts()
    counts_mnist = run_main_path()
    say(f"  launch counts: {json.dumps(counts_mnist)}")
    for name in ("fedavg", "quantize", "dequantize"):
        if counts_mnist.get(name, 0) <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"main path")

    say(f"[5] adaptive fleet path: 48 clients, MLP 784-32-10, mudp+fec, "
        f"{FLEET_ROUNDS} rounds")
    counts_fleet, bodies, by_shape = run_fleet_path()
    say(f"  launch counts: {json.dumps(counts_fleet)}")
    for name in ("topk_gather", "topk_scatter", "quantize", "dequantize",
                 "fedavg"):
        if counts_fleet.get(name, 0) <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"adaptive fleet path")
    counts_ck = run_checksum_path(bodies)
    say(f"  launch counts: {json.dumps(counts_ck)}")
    if counts_ck["checksum"] <= 0:
        raise AssertionError("kernel checksum never launched")

    # Each kernel's launches on its own path: slice 1's kernels on phase
    # 4's path (their count on the fleet path beside it), the top-k
    # kernels on the fleet path, checksum on the pass over its bodies.
    path_counts = {"fedavg": counts_mnist, "quantize": counts_mnist,
                   "dequantize": counts_mnist, "topk_gather": counts_fleet,
                   "topk_scatter": counts_fleet, "checksum": counts_ck}
    out = []
    for name in MAIN_SHAPE:
        rec = rows[name][MAIN_SHAPE[name]]
        out.append({"name": name, "route": "cuda", "source": SOURCES[name],
                    "replaces": REPLACES[name],
                    "launches": path_counts[name][name],
                    "launches_fleet_path": counts_fleet[name],
                    "launches_by_shape": by_shape.get(name),
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
