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
   published-peak bound (and the kernel's share of it) and the bound
   from a same-size ``copy_`` measured here, and the time of one PyTorch
   call computing the same function where there is one (for dequantize
   a per-channel quantized tensor's ``.dequantize()``, held bitwise and
   timed over back-to-back calls, since no CUDA graph captures it).  The
   top-k scatter and dequantize are also held at their edge cases:
   unordered rows and duplicates over many tiles beside increasing ones,
   one tile, K = 0, widths off the 16-byte grid, 70,000 rows and bad
   indices (which must raise); n % 4 = 1, 2, 3, blocks of 1000, 7 and 1,
   the top-k tier lengths, 65,537 rows and codes off the grid.  Quantize
   is also held at one leaf of each row width of phase 14 (QUANT_LEAVES)
   and at its edge cases (QUANT_EDGES: n % 4 = 1, 2, 3 over several rows,
   blocks 1, 7, 1000, a block size for each of its kernels by vector and
   scalar loads, 65,537 rows, x off the 16-byte grid), each against the
   plain version and numpy, and each timing line names the route
   ``ops.quantize_plan`` picked and ends with its share of the bound.
   The top-k gather's bound is also counted the way the card reads x:
   the distinct 32-byte sectors its indices touch (counted on the card),
   plus the indices and the values written; both shares are printed.
   The gather's bad-index calls good, bad, good, bad, bad must raise at
   the bad ones only, and three gather calls captured in a CUDA graph
   must be three kernel nodes (no memset).
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
6. gemma3-12b serving at full width (48 layers, d_model 3840, vocab
   262,144, seeded bf16 parameters on the card): one prefill of B=2 x
   2048 tokens through ``make_prefill_step`` (the flash attention kernel,
   48 launches; local layers mask a 1024 window), then 16 greedy decode
   steps from its KV cache grown to P + 16.  Holds: (a) the prefill with
   the kernel's plain version gives last-position logits and each layer's
   K/V within the stated relative L2 errors; (b) a prefill of the first
   P-1 tokens plus one decode step gives the full prefill's logits within
   the same error; (c) top-1 tokens agree wherever the top-2 margin
   exceeds the error.  Prints prefill and decode wall time, launches and
   peak memory (and the peak just after the prefill).
7. xlstm-350m serving at full width (24 layers, d_model 1024, mLSTM head
   width 512): B=4 x 2048 tokens (the chunkwise mLSTM kernel, 21
   launches), 16 greedy steps from the recurrent state, holds (a)-(c) with
   the recurrent decode in (b); then ``python -m repro_torch.launch.serve
   --arch xlstm-350m --device cuda``, and ``serve --smoke`` for both
   models (head widths 16 and 32), as subprocesses must exit 0.
8. xlstm-350m training at full width (0.47 B bf16 parameters, AdamW with
   float32 moments, B=4 x 128 tokens): ``python -m
   repro_torch.launch.train`` for 3 steps with a checkpoint directory,
   then again to step 6, which must resume from step 3; then in process
   the step's s/step, tokens/s, peak memory, device idle share over two
   profiled steps and model-FLOP rate (6 N tokens, an estimate); then the
   train step on the card against the same step on the CPU at smoke size
   in float32, for xlstm-350m and gemma3-12b (loss, grad norm, the
   updated parameters).  No kernel may launch on the training path.
9. ``repro_torch.fl_train_lm --scale 100m`` (140.6 M float32 parameters
   a client): 3 clients over WAN links at 5% uplink loss, int8 deltas
   with error feedback through the quantize and dequantize kernels, the
   server's mean through the fedavg kernel, a checkpoint and the journal
   every round, LMFL_ROUNDS rounds.  Per round: the reference's line, the
   wall and its split (local steps, int8 encode/decode, checkpoint save);
   the three kernels' launches and calls by shape.  It must aggregate at
   least 2 of 3 clients a round, end below the first eval NLL, and the
   journal must resume at the next round.  Then ``--scale tiny`` on the
   card and on the CPU: identical round records, NLL within NLL_TOL; and
   one round of one local step on each, whose moves of the global model
   must agree within PARAM_TOL (a run with no-op local steps must not).
10. The MoE, VLM, encdec and hybrid families serving on the card
   (FAMILY_PATHS): olmoe-1b-7b whole at full width (16 layers, d_model
   2048, 64 experts top-8; B=2 x 2048), hymba-1.5b whole (B=2 x 2048,
   past its 1024 window), whisper-tiny whole (1500 frames, B=2, a 64-token
   prompt), qwen3-moe-235b-a22b and qwen2-vl-72b at full width cut to 4
   layers (B=1 x 2048; qwen2-vl with its 64-token vision prefix and M-RoPE
   positions whose height and width channels differ from the temporal
   one); seeded bf16 parameters, 16 greedy steps each, the memory freed
   between them.  Each prints its flash attention launches a prefill
   (16 / 32 / 12 / 4 / 4, failing otherwise), prefill wall, decode ms a
   step, peak memory, a profile of the prefill and of two decode steps,
   holds (a)-(c) as phase 6's, and (d) each bf16 attention call of the
   plain prefill, the kernel no further from the plain version's float32
   twin than BF16_ERROR_RATIO times the plain one.  For the MoE models
   the K/V hold is printed, not held: bf16 rounding flips some tokens'
   top-k experts between two prefills (the share is printed), and those
   tokens' later K/V move with them.  hymba-1.5b also runs on a float32
   copy (f32_twin): the f32 holds against LM_F32_REL_L2, and its bf16
   logits against the float32 model's.  Then ``serve --smoke --device
   cuda`` for one configuration of each family, the four at once.
11. The rest of the fleet layer (``repro_torch.fleet_sim`` and
   ``repro_torch.fleet_gates``), every run at the reference example's full
   width (48 clients, seed 7, a 4 s deadline, ``buffer_k`` 8): (a) its
   consensus arms (1024 parameters, static control, over mudp and udp):
   ``--topology hier --cells 4`` sync, hier with an async root,
   ``--topology gossip --neighbors 4`` and star ``--mode async`` (12
   aggregations), each bitwise against the reference's pins
   (``fleet_sim.PINNED_ARMS``: per round the arrivals, late folds,
   retransmissions and bytes on each hop, and the SHA-256 of the final
   global parameters); (b) the MLP (784-32-10) under hier with adaptive
   control and the per-hop specs, 3 sync rounds over ``mudp+fec``, against
   ``fleet_sim.PINNED_HIER_ADAPTIVE`` (the cells' and the root's tier counts
   included), with the launches of fedavg, quantize, dequantize and the
   top-k gather and scatter and their calls by shape (each must launch);
   (c) the MLP's star sync arm over mudp under ``--train-backend vmap``
   against ``python``: identical rosters, arrivals and ``duration_ns``,
   the global parameters within VMAP_ATOL (their ULP distances printed),
   and ``BatchTrainer.batch_sizes``, fewer calls than trainings; (d) the
   vmap compute matrix (ms a call, python and vmap, at 16, 64 and 256
   clients of the reference benchmark's smoke MLP and at 256 of the full
   one; the speedup beside the reference's 5x gate, printed, not held),
   one profiled vmap call's device time and idle share, and the learning
   curve (16 clients, 10% loss, non-IID alpha 0.5, vmap), which must reach
   0.95 accuracy within 20 rounds; (e) the topology gates (root link
   linear in cells, hier's loss equal to star's, serverless gossip
   reaching 10% of L0) and the async gate (async time-to-target <= 0.8x
   sync).  Each arm prints (f) its round wall, its launches, and the idle
   share of a few more rounds under the profiler.
12. The flow engine at fleet scale (``repro_torch.fleet_scale --engine
   flow``, in process, on the card): (a) small runs (64 clients) of every
   transport under star, hier and gossip and one async run, each report
   equal to the reference's (``fleet_scale.PINS``: the SHA-256 of the
   report outside its wall-clock fields, and bytes, retransmissions,
   arrivals and final loss per cell); (b) the deployment the reference's
   ``benchmarks/fleet_scale.py`` names, ``--topology hier --cells 32
   --transports mudp``, at 10,000 clients for 2 rounds and 100,000 for
   1, each equal to its pin, with its wall, rounds per wall second and
   wall per client, fedavg's launches (fedavg must launch, nothing else
   may) and calls by shape, every fedavg call held bitwise against the
   plain version and the numpy fold, and one profiled round at 10,000
   clients (device busy time and idle share); (c) ``fleet_scale
   --flow-gate`` at 1,024 clients, in a process of its own (a wall-clock
   ratio, kept clear of this process's heap): flow must process at least
   2.0x the packet events per wall second of batched (the reference's
   floor); (d) fedavg at the (K, 2048)
   stacks (b) launched (each run's largest, median and smallest cell, and
   the root): its route, device time, the bound (bytes / 3.35 TB/s) and
   its share, and the plain version's and ``w @ stack``'s device times.
13. The paper's experiment and the reference's benchmark gates through
   the port's entry points on the card, each part a path of its own
   (launch counts zeroed before it and read after it, the five FL
   kernels' calls counted by shape): (a) ``repro_torch.paper_cases``, the
   §V cases' trace lines and stats against the reference's pins; (b)
   ``repro_torch.quickstart``: both clients arrive, accuracy improves,
   the round record and trace lines equal their pins, and no kernel
   launches (Eq. 1 folds on the host); (c) ``transport_scenarios``,
   ``transport_comparison --rounds 1`` and ``transport_ablation``, every
   row equal to its pin; (d) ``fl_convergence``: the lossy MUDP arms'
   accuracy equals the lossless arm's and UDP's is lower, round records
   equal their pins, accuracy within 0.01 of the reference's; (e)
   ``adaptive_bench --check`` (adaptive beats every static tier, the 24
   digests under ``control="static"``, every arm equal to its pin); (f)
   ``simcore`` at the reference CI's size, both engines' digests equal to
   the reference's (speedups recorded, no floor); (g) ``wire_bench
   --check --params 250000``: wire hashes equal to the reference's under
   both wire backends, batch bytes equal to the loop's, the numpy batch
   plane at least 4x the loop at 256 clients (the kernel backend's
   speedup printed).  Every fedavg call of (c), (d) and (f) is held
   bitwise against the plain version and the numpy fold.
14. The mesh tooling on the card: (a) hymba-1.5b's seeded parameters at
   its published width stacked for 4 pods (each with its own seeded
   perturbation) and aggregated by ``repro_torch.distributed.fl_mesh.
   make_fl_aggregate`` in ``exact`` mode (fedavg) and ``int8`` mode (the
   row-wise quantize, dequantize and fedavg), each mode a path of its
   own: its wall, launches and calls by shape, the bytes each pod would
   send and the peak memory, then two more aggregations, the second with
   each kernel call between CUDA events (each kernel's device time over
   its calls beside its bound: inputs read and outputs written once);
   every leaf must equal, bitwise, the same aggregation through the
   plain versions on the card, every pod must hold the same values, and
   the int8 float32 means must lie within absmax / 254 a row of the
   exact ones (under ``--parent`` the int8 quantize calls are timed with
   the replaced kernel too, in turns); (b) the dry-run's estimate
   (``repro_torch.launch.lowering.estimate_cell``) of phase 6's prefill
   and a decode step over its grown cache, phase 7's prefill and phase
   8's train step: estimated and model FLOPs, the useful ratio, the
   estimated and the measured peak (the gemma3-12b prefill's within
   DRYRUN_PEAK_TOL of the peak just after it, the rest printed), and
   the phase's model-FLOP rate against the bf16 peak; (c) ``python -m
   repro_torch.launch.dryrun`` on one cell and ``python -m
   repro_torch.roofline`` must exit 0 (their files go to
   ``build/port_dryrun/``).
15. The reference's benchmark harness on the port
   (``repro_torch.bench_run``): (a) all 14 suites in this process, each
   suite's wall, launches and calls by shape; every row present and in
   order, no suite error (a kernel off its contract is one), every
   deterministic field on its pin (``bench_run.PINS``), each kernel row
   on the ``cuda`` route, each of the eight kernels launched, and every
   call of the five FL kernels bitwise against its plain version (fedavg
   also against the numpy fold); (b) ``python -m repro_torch.bench_run
   --only kernels`` in its own process must exit 0 and hold the same;
   (c) the aggregation and kernels suites again, in this process and a
   fresh one, each kernels row taken apart: its calls' host, sync and
   event-span times and new allocator segments, and the garbage
   collector's time in its reps.
16. A JSON line with every kernel's numbers (``launches_phase15`` by
   suite among them), one with phases 8, 9, 11-15's, the card line again,
   and the result line ``{"ok": true, "device": {...}}`` last.

Phase 2 also holds the flash attention and mLSTM kernels against their
plain versions at the serving shapes and at a 1500-token prompt, in bf16
and f32 (flash attention also at each layer shape of phase 10, with
SDPA's device time beside the kernel's), and times the serving shapes
beside the bf16 tensor-core bound (and, for attention,
``scaled_dot_product_attention``), with achieved
TFLOP/s and the share of the bound beside each time.  The tensor-core
flash attention kernel (bf16 at hd 64, 128, 256) is held at hd 64 and
128 too (1500 tokens, window 1000, GQA).  The tensor-core mLSTM kernel
(bf16 at dh 512) is held at S = 1, 63, 65 and 200 too, and with a q base
off the 16-byte grid; at the serving shapes it is also timed alone on
the device (the bare launch, without the wrapper's gate terms), and the
bf16 error is printed against the f32 plain version and against the
plain version in the kernel's own form.  It holds both kernels at the
head widths between the compiled ones too (the wrappers zero-pad to the
next: C1_FLASH, C1_MLSTM), and times fedavg, quantize and dequantize at
phase 9's shapes.  Phase 1 prints each
tensor-core kernel's ptxas registers and spills and its shared memory a
CTA, and fails on a spill.

Launch counts are zeroed just before each path (phases 4, 5, the
checksum pass of 5, the serving run of 6, of 7 and of each configuration
of 10, the training steps of 8, the rounds of 9 and of each arm of 11,
each of phase 12's runs at users' scale, each part of phase 13 and each
mode of phase 14(a), the harness run of phase 15(a)) and read just after
it, so the comparison launches
of phase 2, of the ``encode_batch`` check and of the serving and
aggregation holds do not count.

``--parent DIR`` builds the quantize and top-k gather of a checkout
from before their redesign (``DIR/src/repro_torch/kernels``; each whose
family source differs from this checkout's) and times
each just before and just after this one at every phase-2 shape, and
quantize also over phase 14(a)'s int8 aggregation (parent, this, this,
parent), on the same card.

fedavg (redesigned for tall, narrow stacks) is held at more shapes in
phase 2: the path's, the flow fleets' cells and root, a 60,000-client
fold, strides off the 16-byte grid and the first N of each route, tile
and stage size of ``ops.plan`` (FEDAVG_SHAPES), each line naming its
route, plus its edge cases; phase 1 prints each of its 19 kernels'
ptxas registers, spills and static shared memory and fails on a spill;
phase 12(d) names the route at each stack.  Phase 1 also prints the
ptxas registers, spills and shared memory of the gather and of each
quantize kernel (every (lanes, units) of ``ops.QUANT_KERNELS`` and the
wide route) and fails on a spill.

It exits non-zero with no result when CUDA is unavailable.
"""

from __future__ import annotations

import json
import os
import re
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
# fedavg beyond those two: the MLP's hier cells (phase 11), the flow
# fleets' cells and root (phase 12), a 60,000-client fold (a 100,000-client
# star flow fleet at participation 0.6), strides off the 16-byte grid, and
# the first N of each tall tile of ``ops.plan`` (8, 16, 32, 64, 128 columns
# a CTA) by tma and cp_async, at 64 clients (4 KB stages) and 600 (8 KB),
# then the last tall N and the first wide one.  Each is held bitwise and
# timed with its route printed.
FEDAVG_SHAPES = {
    "hier_cell": (12, SLICE_N), "flow_root": (32, 2048),
    "flow_10k": (188, 2048), "flow_100k": (1875, 2048),
    "unaligned": (190, 2050), "unaligned_tall": (1875, 2050),
    "k60000": (60_000, 2048),
    **{f"{route}{c}_{k}": (k, n + (route == "cp"))
       for c, n in ((16, 2100), (32, 4196), (64, 8388))
       for route in ("tma", "cp") for k in (64, 600)},
    "tma128": (600, 16_772), "cp128": (600, 16_773),
    "tall_last": (64, 67_580), "wide_first": (64, 67_584),
    # phase 13's: transport_comparison / transport_ablation, fl_convergence
    # and simcore's fl_round
    "pair_40000": (2, 40_000), "pair_25450": (2, SLICE_N),
    "simcore_64": (64, 32_768)}
#: beyond this many clients the plain version (two launches a client) is
#: held once and timed on the device in graphs of 2 calls, not 20
FEDAVG_PLAIN_DEEP = 200
#: and beyond this, held once and not timed
FEDAVG_PLAIN_UNTIMED = 10_000
# The adaptive path's top-k shapes, (rows, dense width, kept): one
# client's row at each tier of the ladder (topk(0.4), (0.15), (0.04) of
# 25,450), which every client's encode gathers and its EF residual decode
# scatters; the server's batch decode of a tier-0 and a tier-2 group; a
# large one at 15% density.
TIER_K = {"t0": 10_180, "t1": 3817, "t2": 1018}
CLIENT_SHAPES = {f"client_{t}": (1, SLICE_N, k) for t, k in TIER_K.items()}
# wire_bench's batch sweep (phase 13): 256 clients' topk(0.01) of 256,
# and one client's row of it, the shape its loop runs most often
WIRE_BATCH, WIRE_CLIENT = (256, 256, 2), (1, 256, 2)
TOPK_SHAPES = {
    "topk_gather": dict(CLIENT_SHAPES, wire_batch=WIRE_BATCH,
                        wire_client=WIRE_CLIENT,
                        large=(64, 1 << 20, 157_286)),
    "topk_scatter": dict(CLIENT_SHAPES, group_t0=(18, SLICE_N, 10_180),
                         group_t2=(25, SLICE_N, 1018), wire_batch=WIRE_BATCH,
                         wire_client=WIRE_CLIENT,
                         large=(64, 1 << 20, 157_286))}
# quantize and dequantize at wire_bench's batch shape under int8(256) and
# int8(1024) (phase 13), and at one client's two kept values of it (n far
# below a block: the padded lanes), by key: (rows, n, block)
QUANT_WIRE = {"wire_b256": (256, 256, 256), "wire_b1024": (256, 256, 1024),
              "wire_kept_b256": (1, 2, 256), "wire_kept_b1024": (1, 2, 1024)}
# quantize at one leaf of each row width that phase 14's int8 aggregation
# quantizes (hymba-1.5b x 4 pods, in blocks of the width): ssm w_B (16),
# wk (64), w_in (1600) and w_up (5504), by key: (rows, n, block)
QUANT_LEAVES = {"leaf_d16": (204_800, 16, 16),
                "leaf_d64": (1_024_000, 64, 64),
                "leaf_d1600": (204_800, 1600, 1600),
                "leaf_d5504": (204_800, 5504, 5504)}
CHECKSUM_LARGE = 256 << 20               # bytes
FLEET_ROUNDS = 10
#: the shape at which each kernel runs most often on its path (phases 4
#: and 5; phase 5 prints the top-k kernels' calls by shape)
MAIN_SHAPE = {"fedavg": "batch", "quantize": "client",
              "dequantize": "batch", "topk_gather": "client_t2",
              "topk_scatter": "client_t2", "checksum": "uplink",
              "flash_attention": "local", "mlstm": "path"}
SOURCES = {"fedavg": "src/repro_torch/kernels/fedavg/csrc/fedavg.cu",
           "quantize": "src/repro_torch/kernels/quantize/csrc/quantize.cu",
           "dequantize": "src/repro_torch/kernels/quantize/csrc/quantize.cu",
           "topk_gather": "src/repro_torch/kernels/topk/csrc/topk.cu",
           "topk_scatter": "src/repro_torch/kernels/topk/csrc/topk.cu",
           "checksum": "src/repro_torch/kernels/checksum/csrc/checksum.cu",
           "flash_attention": "src/repro_torch/kernels/flash_attention/csrc/"
                              "flash_attention.cu",
           "mlstm": "src/repro_torch/kernels/mlstm/csrc/mlstm.cu"}
REPLACES = {"fedavg": "src/repro/kernels/fedavg/fedavg.py:32",
            "quantize": "src/repro/kernels/quantize/quantize.py:40",
            "dequantize": "src/repro/kernels/quantize/quantize.py:68",
            "topk_gather": "src/repro/kernels/topk/topk.py:48",
            "topk_scatter": "src/repro/kernels/topk/topk.py:67",
            "checksum": "src/repro/kernels/checksum/checksum.py:50",
            "flash_attention":
                "src/repro/kernels/flash_attention/flash_attention.py:77",
            "mlstm": "src/repro/kernels/mlstm/mlstm.py:79"}
WARMUP, REPS = 3, 20
PEAK_BF16_FLOPS = 989e12          # H100 SXM dense bf16 tensor cores
# LM serving at full width (phases 6-7): (batch, prompt) per model, the
# greedy steps after the prefill, and the kernels' launches per prefill
# (gemma3-12b: one flash attention per layer; xlstm-350m: one mLSTM per
# mLSTM layer, 3 groups x 7).
# ``f32_twin``: the holds also run on a float32 copy of the parameters
# (see LM_F32_REL_L2).
LM_PATHS = {"gemma3-12b": {"batch": 2, "prompt": 2048,
                           "kernel": "flash_attention", "per_prefill": 48,
                           "f32_twin": False},
            "xlstm-350m": {"batch": 4, "prompt": 2048, "kernel": "mlstm",
                           "per_prefill": 21, "f32_twin": True}}
GEN_STEPS = 16
TAIL_S = 1500                     # a prompt no 64-row tile divides
# Head widths between the compiled ones, which the wrappers zero-pad to
# the next (phase 2): the reference's own kernel-test shapes at hd / dh 32
# (tests/test_kernels.py), the smoke configs' widths, and the mLSTM width
# of fl_train_lm --scale 100m (dh 320, padded to 512).
C1_FLASH = [  # (B, S, H, KV, hd, window, dtype)
    (2, 384, 3, 3, 32, 128, "float32"),     # test_kernels.py:163
    (1, 128, 1, 1, 32, 0, "float32"),       # :202, the tiling sweep
    (1, 512, 1, 1, 32, 0, "float32"),
    (1, 512, 1, 1, 64, 0, "float32"),
    (2, 48, 4, 2, 16, 16, "float32"),       # smoke gemma3-12b's layer
    (2, 300, 4, 2, 32, 64, "bfloat16"),
    (2, 130, 4, 2, 16, 0, "bfloat16"),
]
C1_MLSTM = [  # (B, S, nh, dh, f_shift, dtype)
    (2, 256, 1, 32, 2.0, "float32"),        # test_kernels.py:218
    (1, 128, 2, 32, 1.0, "float32"),        # :236
    (1, 256, 3, 32, 0.0, "float32"),        # :260
    (2, 512, 4, 320, 2.0, "bfloat16"),      # fl_train_lm --scale 100m
]
# Phase 8: xlstm-350m training at full width, in two invocations of the
# training entry point (the second resumes from the first's checkpoint), then
# in process: TRAIN_TIMED steps timed after one warm-up, two profiled.
TRAIN = {"arch": "xlstm-350m", "batch": 4, "seq": 128, "steps": (3, 6)}
TRAIN_TIMED = 3
# The train step on the card against the same step on the CPU (f32, smoke
# size, B=4 x 64 tokens, AdamW and SGD at lr 1e-3): the loss and the grad
# norm (relative), the SGD update (the gradient's own, relative L2) and
# the share of elements whose AdamW update differs by more than 1e-6 (its
# first step is lr * g / (|g| + eps), which flips where the two gradients
# straddle 0); the AdamW update also within 2 lr everywhere.  Each hold is
# (floor, ceiling): the larger of the floor and twice the model's own
# conditioning, measured in the same run (the largest change that noise
# of one float32 ulp, 2^-24 relative, on the weights makes to that
# quantity on the CPU, over two draws), but never above the ceiling.  At
# random init the xLSTM's sLSTM recurrences amplify rounding: such noise
# moves its SGD update by 0.5-1.1% and its grad norm by 0.2-0.4% (CPU),
# gemma3-12b's update by 2.3e-4.
TRAIN_HOLD = {"xlstm-350m": {"loss": (1e-4, 1e-3), "grad_norm": (1e-3, 2e-2),
                             "sgd": (1e-2, 3e-2), "adam_share": (0.05, 0.1)},
              "gemma3-12b": {"loss": (1e-5, 1e-4), "grad_norm": (1e-4, 1e-3),
                             "sgd": (1e-3, 3e-3),
                             "adam_share": (0.01, 0.03)}}
# Phase 9: fl_train_lm --scale 100m, 3 clients over WAN links at 5% loss;
# the rounds are cut to LMFL_ROUNDS (the width is not), and the tiny scale
# on the card and on the CPU.  NLL_TOL and PARAM_TOL are
# tests/test_torch_fl_lm.py's: the NLL after two rounds of two local steps,
# and the relative L2 distance between two runs' moves of the global model
# after one round of one local step (a longer run is chaotic, see there).
LMFL_ROUNDS = 3
LMFL_TINY = ["--scale", "tiny", "--rounds", "2", "--clients", "2",
             "--local-steps", "2"]
LMFL_ONE_STEP = ["--scale", "tiny", "--rounds", "1", "--clients", "2",
                 "--local-steps", "1"]
NLL_TOL = 0.1
PARAM_TOL = 0.3
# Kernel bands against the plain versions: f32 as tests/test_kernels.py
# holds the Pallas kernels, bf16 as its test_dtypes does;
# |kernel - plain| <= band * (1 + |plain|) elementwise, except the mLSTM
# in bf16: there the gated scores are rounded to bf16 before the product
# with v (as on the TPU), under another stabiliser in the kernel (the
# running row max) than in the plain version (the row max), so each
# output's error scales with its row's signed sum of rounded terms, not
# with the output itself; its band is band * (1 + max |plain| over the
# row's dh outputs).
# Flash attention at the layer shapes of phase 10's serving paths,
# (B, S, T, H, KV, hd, causal, window): olmoe MHA, qwen3-moe GQA 16,
# qwen2-vl GQA 8 (hd 128, causal, 2048 tokens); hymba's local and global
# layers (25 query heads over 5 KV heads, hd 64); whisper's encoder
# (bidirectional over 1500 frames), decoder self-attention and
# cross-attention (64 queries over 1500 frames, no mask).
FAMILY_ATTENTION = {
    "olmoe": (2, 2048, 2048, 16, 16, 128, True, 0),
    "qwen3_moe": (1, 2048, 2048, 64, 4, 128, True, 0),
    "qwen2_vl": (1, 2048, 2048, 64, 8, 128, True, 0),
    "hymba_local": (2, 2048, 2048, 25, 5, 64, True, 1024),
    "hymba_global": (2, 2048, 2048, 25, 5, 64, True, 0),
    "whisper_encoder": (2, 1500, 1500, 6, 6, 64, False, 0),
    "whisper_self": (2, 64, 64, 6, 6, 64, True, 0),
    "whisper_cross": (2, 64, 1500, 6, 6, 64, False, 0),
}
LM_BANDS = {"float32": {"flash_attention": 2e-5, "mlstm": 5e-4},
            "bfloat16": {"flash_attention": 3e-2, "mlstm": 3e-2}}
# Serving holds (bf16 through 24-48 layers): relative L2 error of the
# last-position logits (kernel vs plain prefill; prefill of P-1 tokens
# plus one decode step vs the full prefill), and of each layer's K/V cache
# or each recurrent state (kernel vs plain prefill).
LM_LOGIT_REL_L2 = 5e-2
# Phase 10: (batch, prompt) per configuration; ``layers``: the depth cut
# (0: whole), the width is the published one; the flash attention
# launches per prefill (one per attention layer; whisper: 4 encoder, 4
# decoder self- and 4 cross-attention layers).  Holds (a)-(c) as phase 6,
# and (d) below; ``f32_twin`` as LM_PATHS' (hymba-1.5b: rounding to bf16
# through its 32 parallel attention + SSM blocks moves the plain model's
# K/V by more than LM_STATE_REL_L2 between two bf16 prefills).
FAMILY_PATHS = {
    "olmoe-1b-7b": {"batch": 2, "prompt": 2048, "layers": 0,
                    "per_prefill": 16, "f32_twin": False},
    "hymba-1.5b": {"batch": 2, "prompt": 2048, "layers": 0,
                   "per_prefill": 32, "f32_twin": True},
    "whisper-tiny": {"batch": 2, "prompt": 64, "layers": 0,
                     "per_prefill": 12, "f32_twin": False},
    "qwen3-moe-235b-a22b": {"batch": 1, "prompt": 2048, "layers": 4,
                            "per_prefill": 4, "f32_twin": False},
    "qwen2-vl-72b": {"batch": 1, "prompt": 2048, "layers": 4,
                     "per_prefill": 4, "f32_twin": False},
}
# The bf16 holds against a float32 twin: the kernel route's relative L2
# distance from the float32 result may be at most BF16_ERROR_RATIO times
# the plain route's own distance from it.  Both round to bf16 at the same
# places, so the two errors are of one size.  Hold (d) applies it at each
# bf16 attention call of a plain prefill (the plain version's float32
# twin on the same bf16 inputs); with ``f32_twin`` it also holds the whole
# model's bf16 logits, of the prefill and of prefill(P-1) + one decode
# step, against the float32 model's plain prefill.
BF16_ERROR_RATIO = 2.0
# ``serve --smoke --device cuda``: one configuration of each family
FAMILY_SERVE_SMOKE = ("olmoe-1b-7b", "qwen2-vl-72b", "whisper-tiny",
                      "hymba-1.5b")
LM_STATE_REL_L2 = 3e-2
# The xLSTM at random init is too sensitive for bf16 holds of that size:
# rounding its activations to bf16 at all moves the last-position logits
# by 0.79 relative L2 from a float32 run of the same plain model, while
# each mLSTM layer's kernel output lies 4.3e-4 to 5.1e-4 from the plain
# one (5x under that layer's own bf16-vs-f32 error) and, in float32, the
# whole prefill 1.7e-3 from the plain prefill (phase 7 on an NVIDIA H100
# 80GB HBM3 at 700 W).  So its holds run in float32 against
# LM_F32_REL_L2, and in bf16 against the model's own bf16 error (kernel
# vs plain no larger than plain bf16 vs plain f32, for the whole model
# and for each layer).
LM_F32_REL_L2 = 1e-2


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


def device_ms_events(fn, calls: int = 20) -> float:
    """Device time of one ``fn()`` for calls a CUDA graph cannot capture:
    ``calls`` calls back to back between two CUDA events, the median of
    REPS such runs divided by ``calls``.  The host's launches overlap the
    device's work, so at a shape that keeps the device busy longer than a
    launch takes this reads the device's time."""
    import torch
    for _ in range(WARMUP):
        fn()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def bits_equal(a, b) -> bool:
    import torch
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and bool(torch.equal(a, b))


def bound_ms(nbytes: int, flops: int,
             peak_flops: float = PEAK_F32_FLOPS) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# --------------------------------------------------------------------------
class ParentKernels:
    """The quantize and top-k gather launchers of a checkout from before
    their redesign (``--parent DIR``), built with the port's flags into
    ``build/torch_kernels/parent-*.so``, so that phases 2 and 14(a) time
    each beside the kernel that replaced it, in turns, in one run.  Their
    C interface is that checkout's: ``quantize_f32_i8(x, q, scales, rows,
    n, nb, block, stream)`` (one CTA a block) and
    ``topk_gather_f32(x, idx, out, rows, P, K, err, stream)`` (which
    zeroes ``err``, an int, then launches).  A kernel whose family source
    this checkout still has unchanged replaced nothing: it is not built,
    and ``has`` says so.  (The scatter, dequantize and fedavg were timed
    beside the kernels they replaced when they were redesigned; the
    checkout just before this redesign holds the same ones as this.)"""

    #: kernel -> (family, launcher, its arguments but the stream: p a
    #: pointer, l a long long, i an int)
    KERNELS = {"quantize": ("quantize", "quantize_f32_i8", "ppplliip"),
               "topk_gather": ("topk", "topk_gather_f32", "ppplllpp")}

    def __init__(self, root: str):
        from repro_torch.kernels import _build
        kdir = os.path.join(os.path.abspath(root), "src", "repro_torch",
                            "kernels")

        def source(base, f):
            with open(os.path.join(base, _build.SOURCES[f]), "rb") as fh:
                return fh.read()
        self.families = tuple(sorted(
            {f for f, _, _ in self.KERNELS.values()
             if source(kdir, f) != source(_build._PKG, f)}))
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        self.libs = {f: _build.BUILD_DIR / f"parent-{f}.so"
                     for f in self.families}
        self.procs = [subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{kdir}/csrc", "-o",
             str(self.libs[f]), os.path.join(kdir, _build.SOURCES[f])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for f in self.families]

    def has(self, kernel: str) -> bool:
        return self.KERNELS[kernel][0] in self.families

    def load(self) -> None:
        """Wait for the builds (started in __init__) and load them."""
        import ctypes
        for f, proc in zip(self.families, self.procs):
            log = proc.communicate()[0].decode(errors="replace")
            if proc.returncode:
                raise AssertionError(f"parent {f} build failed:\n{log}")
        kinds = {"p": ctypes.c_void_p, "l": ctypes.c_longlong,
                 "i": ctypes.c_int}
        self.fns = {}
        for kernel, (f, name, args) in self.KERNELS.items():
            if f in self.families:
                fn = getattr(ctypes.CDLL(str(self.libs[f])), name)
                fn.argtypes = [kinds[a] for a in args]
                fn.restype = ctypes.c_int
                self.fns[kernel] = fn
        say(f"  parent kernels built: {sorted(self.fns) or 'none'} (the "
            f"others' sources are unchanged)")

    def _call(self, kernel: str, *args) -> None:
        import torch
        rc = self.fns[kernel](*args, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise AssertionError(f"parent {kernel}: cudaError {rc}")

    def gather(self, x, idx, out, err) -> None:
        """``err``: (1,) int32, which the parent's launcher zeroes."""
        rows, p = x.shape
        self._call("topk_gather", x.data_ptr(), idx.data_ptr(),
                   out.data_ptr(), rows, p, idx.shape[1], err.data_ptr())

    def quantize(self, x, q, scales, block) -> None:
        rows, n = x.shape
        self._call("quantize", x.data_ptr(), q.data_ptr(), scales.data_ptr(),
                   rows, n, scales.shape[1], block)


def recorder(rows: dict):
    """``record``: times a kernel at one shape into ``rows`` (name ->
    shape name -> its numbers)."""
    import torch

    dev = torch.device("cuda")

    def record(name, key, shape, nbytes, flops, kernel_fn, plain_fn, lib_fn,
               err, launch_fn=None, peak_flops=PEAK_F32_FLOPS,
               parent_fn=None, lib_in_graph=True, plain_calls=20):
        """Time the kernel, its plain version and the library call (if
        any) both ways: per call (host launch included) and on the device
        alone; keep the numbers under rows[name][key].  ``launch_fn``,
        where given, is the bare launch into preallocated buffers that
        the device timing captures in place of the wrapper (whose read of
        the kernel's bad-index flag waits for the host).  ``parent_fn``,
        where given, is the launch it replaced (``--parent``): its device
        time is taken just before and just after the others'.  A library
        call that a CUDA graph cannot capture (``lib_in_graph=False``) is
        timed on the device by ``device_ms_events``; the plain version's
        graph holds ``plain_calls`` calls.  Returns the numbers kept."""
        bnd, by = bound_ms(nbytes, flops, peak_flops)
        n = max(1, nbytes // 2)
        src = torch.empty(n, dtype=torch.uint8, device=dev)
        dst = torch.empty_like(src)
        fns = {"ms": kernel_fn, "plain_ms": plain_fn, "library_ms": lib_fn,
               "copy_ms": lambda: dst.copy_(src)}
        per_call = {k: time_ms(f) if f else None for k, f in fns.items()}
        parent = [device_ms(parent_fn)] if parent_fn else []

        def on_device(k, f):
            if f is None:
                return None
            if k == "library_ms" and not lib_in_graph:
                return device_ms_events(f)
            return device_ms(f, plain_calls if k == "plain_ms" else 20)
        on_dev = {k: on_device(k, f)
                  for k, f in dict(fns, ms=launch_fn or kernel_fn).items()}
        if parent_fn:
            parent.append(device_ms(parent_fn))
        del src, dst

        def fmt(d):
            return ", ".join(f"{k} {v:.6f}" for k, v in d.items()
                             if v is not None)
        say(f"  {name} {shape}: per call: {fmt(per_call)}; device: "
            f"{fmt(on_dev)}; {nbytes} bytes, "
            f"{nbytes / on_dev['ms'] / 1e6:.1f} GB/s on the device, bound "
            f"{bnd:.6f} ms ({by}, {bnd / on_dev['ms']:.3f} of it), "
            f"max_abs_err {err}")
        if parent:
            say(f"    parent's kernel on the device: {parent[0]:.6f} / "
                f"{parent[1]:.6f} ms (before / after); this one "
                f"{on_dev['ms']:.6f} ms, "
                f"{on_dev['ms'] / statistics.mean(parent):.3f} of it")
        if peak_flops == PEAK_BF16_FLOPS:
            say("    on the device: " + "; ".join(
                f"{k} {flops / t / 1e9:.1f} TFLOP/s ({bnd / t:.4f} of the "
                f"bound)" for k, t in on_dev.items()
                if t is not None and k != "copy_ms"))
        rec = rows.setdefault(name, {})[key] = {
            "shape": list(shape), "ms": per_call["ms"],
            "plain_ms": per_call["plain_ms"],
            "library_ms": per_call["library_ms"], "bound_ms": bnd,
            "bound_by": by, "copy_bound_ms": per_call["copy_ms"],
            "bytes": nbytes, "flops": flops, "max_abs_err": err,
            "device": on_dev, "parent_device_ms": parent or None}
        return rec
    return record


def check_kernels(parent: ParentKernels | None = None):
    import torch

    dev = torch.device("cuda")
    rows: dict[str, dict[str, dict]] = {}   # name -> shape name -> rec
    record = recorder(rows)
    check_fedavg(dev, record)
    check_quantize(dev, record, parent)
    check_quantize_edges(dev)
    check_dequantize_edges(dev)
    check_topk(dev, record, rows, parent)
    check_topk_edges(dev)
    check_checksum(dev, record)
    check_lm_kernels(dev, record, rows)
    check_family_attention(dev, rows)
    check_head_widths(dev, rows)
    check_lm_fl_kernels(dev, record, parent)
    return rows


def _numpy_fold(stack_np, w_np):
    """The host fold that the fedavg kernel must equal bit for bit."""
    import numpy as np
    acc = np.zeros(stack_np.shape[1], np.float32)
    for wi, row in zip(w_np, stack_np):
        acc += wi * row
    return acc


def _fedavg_plan(stack, w):
    from repro_torch.kernels.fedavg import ops as fedavg_ops
    k, n = stack.shape
    return fedavg_ops.plan(k, n, fedavg_ops.is_aligned(stack, w))


def _say_plan(stack, w) -> str:
    p = _fedavg_plan(stack, w)
    stage = f", stages of {p.stage * 4} bytes" if p.stage else ""
    return (f"route {p.route}, {p.tile} columns a CTA, "
            f"{p.blocks(stack.shape[1])} CTAs{stage}")


def check_fedavg(dev, record) -> None:
    """Phase 2 for fedavg at SHAPES["fedavg"] and FEDAVG_SHAPES: each held
    bitwise against the plain version (and, but for "large", the numpy
    fold), its route printed, then timed (``record``); the edge cases K = 1,
    N < a tile, N = 0 held too."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.kernels.fedavg import ops as fedavg_ops
    from repro_torch.kernels.fedavg import ref as fedavg_ref

    shapes = dict(SHAPES["fedavg"], **FEDAVG_SHAPES)
    for key, (k, n) in shapes.items():
        host_data = key != "large"
        gen = torch.Generator(device=dev).manual_seed(1000 * k + n)
        stack = torch.randn((k, n), generator=gen, device=dev)
        w = torch.rand(k, generator=gen, device=dev) + 0.5
        w = w / w.sum()
        out = fedavg_ops.fedavg(stack, w)
        plain = fedavg_ref.fedavg(stack, w)
        torch.cuda.synchronize()
        if not bits_equal(out, plain):
            raise AssertionError(f"fedavg {k}x{n}: kernel != plain version")
        if host_data and not bits_equal(out.cpu(), torch.from_numpy(
                _numpy_fold(stack.cpu().numpy(), w.cpu().numpy()))):
            raise AssertionError(f"fedavg {k}x{n}: kernel != numpy fold")
        say(f"  fedavg {(k, n)}: {_say_plan(stack, w)}; kernel == plain"
            f"{' == numpy fold' if host_data else ''}")
        err = float((out - plain).abs().max())
        del plain
        record("fedavg", key, (k, n), 4 * k * n + 4 * k + 4 * n, 2 * k * n,
               lambda: fedavg_ops.fedavg(stack, w),
               None if k > FEDAVG_PLAIN_UNTIMED
               else lambda: fedavg_ref.fedavg(stack, w),
               lambda: w @ stack, err,
               plain_calls=2 if k > FEDAVG_PLAIN_DEEP else 20)
        del stack, w, out
    torch.cuda.empty_cache()

    rng = np.random.default_rng(21)
    for k, n, offset in ((1, 2048, 0), (1, 7, 0), (3, 7, 0), (5, 1, 0),
                         (300, 2048, 1), (300, 2048, 4), (2, 0, 0)):
        # offset: the stack a view one or four floats into its buffer, so
        # its base is off the 16-byte grid (cp_async) or back on it (tma)
        stack_np = rng.standard_normal((k, n)).astype(np.float32)
        w_np = (rng.random(k) + 0.5).astype(np.float32)
        buf = torch.zeros(k * n + offset, device=dev)
        buf[offset:] = torch.from_numpy(stack_np).to(dev).reshape(-1)
        stack = buf[offset:].view(k, n)
        w = torch.from_numpy(w_np).to(dev)
        before = kernels.launch_counts["fedavg"]
        out = fedavg_ops.fedavg(stack, w)
        launched = kernels.launch_counts["fedavg"] - before
        torch.cuda.synchronize()
        if not (bits_equal(out, fedavg_ref.fedavg(stack, w))
                and bits_equal(out.cpu(), torch.from_numpy(
                    _numpy_fold(stack_np, w_np)))
                and launched == (1 if n else 0)):
            raise AssertionError(f"fedavg edge {(k, n)} offset {offset}: "
                                 f"kernel != plain / numpy, or {launched} "
                                 f"launches")
    say("  fedavg edges (1, 2048), (1, 7), (3, 7), (5, 1), (300, 2048) one "
        "and four floats into a buffer, (2, 0): kernel == plain == numpy "
        "fold, one launch (none at N = 0)")


def _dequantize_library(q, scales, n: int, block: int, want):
    """The one PyTorch call that computes dequantize: a per-channel
    quantized tensor of the codes, one channel a block (built once, here),
    whose ``.dequantize()`` is timed.  Returns (the call or None, what to
    print); the call's output is held bitwise against ``want`` (it also
    expands the padded lanes, which the comparison drops)."""
    import torch
    rows, nb = scales.shape
    try:
        qt = torch._make_per_channel_quantized_tensor(
            q.view(rows * nb, block), scales.reshape(-1).double(),
            torch.zeros(rows * nb, dtype=torch.long, device=q.device), 0)
        got = qt.dequantize().view(rows, nb * block)[:, :n]
    except (RuntimeError, NotImplementedError) as e:
        return None, f"none ({type(e).__name__}: {str(e).splitlines()[0]})"
    return qt.dequantize, (f"bitwise equal to the kernel: "
                           f"{bits_equal(got, want)}; a CUDA graph cannot "
                           f"capture it, so its device time is 20 calls "
                           f"back to back between two events")


def _record_dequantize(record, key, q, scales, n, block, out) -> None:
    """Time dequantize at one shape (``out``: the kernel's output, already
    held against the plain version), with the library yardstick."""
    from repro_torch.kernels.quantize import ops as quant_ops
    from repro_torch.kernels.quantize import ref as quant_ref
    rows, nb = scales.shape
    lib_fn, lib_note = _dequantize_library(q, scales, n, block, out)
    say(f"  dequantize {(rows, n)} library yardstick "
        f"(per-channel quantized tensor .dequantize()): {lib_note}")
    # Reads the n codes of a row that it expands and the scales, writes
    # the output; one multiply an element.
    record("dequantize", key, (rows, n), rows * n + 4 * rows * nb
           + 4 * rows * n, rows * n,
           lambda: quant_ops.dequantize(q, scales, n, block),
           lambda: quant_ref.dequantize(q, scales, n, block), lib_fn,
           0.0, lib_in_graph=False)


def _quant_route(x, block: int) -> str:
    """What ops.quantize_plan launches for ``x`` in blocks of ``block``."""
    from repro_torch.kernels.quantize import ops as quant_ops
    p = quant_ops.quantize_plan(*x.shape, block,
                                quant_ops.is_aligned(x, block))
    if p.route == "wide":
        return f"route wide, a CTA a block, {p.grid} CTAs"
    return (f"route {p.route}, {p.lanes} lanes a block, {p.units} float4 "
            f"units a lane, {p.per_cta} blocks a CTA, {p.grid} CTAs, "
            f"{'vector' if p.vector else 'scalar'} loads")


def _quantize_parent_fn(parent, x, block: int, q, scales):
    """Under ``--parent``: the replaced quantize into buffers of its own,
    held bitwise against this kernel's ``q`` and ``scales`` first; else
    None."""
    import torch
    if parent is None or not parent.has("quantize"):
        return None
    q_old, s_old = torch.empty_like(q), torch.empty_like(scales)
    parent.quantize(x, q_old, s_old, block)
    torch.cuda.synchronize()
    if not (bits_equal(q_old, q) and bits_equal(s_old, scales)):
        raise AssertionError(f"quantize {tuple(x.shape)} in blocks of "
                             f"{block}: the parent's kernel disagrees")
    return lambda: parent.quantize(x, q_old, s_old, block)


def _record_quantize(record, key, x, block, q, scales, parent,
                     plain_calls=20) -> None:
    """Time quantize at one shape (``q``, ``scales``: the kernel's output,
    already held), under ``--parent`` beside the launch it replaced; then
    a line with the plan's route and the share of the bound."""
    from repro_torch.kernels.quantize import ops as quant_ops
    from repro_torch.kernels.quantize import ref as quant_ref
    r, n = x.shape
    nb = scales.shape[1]
    # quantize reads x and writes every code (padding included) and
    # scale; |x|, max, divide, round, two clamps per element (the padded
    # lanes need none of it).
    rec = record("quantize", key, (r, n), 4 * r * n + r * nb * block
                 + 4 * r * nb, 6 * r * n,
                 lambda: quant_ops.quantize(x, block),
                 lambda: quant_ref.quantize(x, block), None, 0.0,
                 parent_fn=_quantize_parent_fn(parent, x, block, q, scales),
                 plain_calls=plain_calls)
    t = rec["device"]["ms"]
    say(f"  quantize {(r, n)} in blocks of {block}: "
        f"{_quant_route(x, block)}; device {t:.6f} ms, "
        f"{rec['bound_ms'] / t:.3f} of the bound")


def _hold_quantize(x, block: int, what: str):
    """quantize(x) on the card, bitwise against the plain version and
    numpy's quantize_int8_batch (on x's host copy); returns (q, scales)."""
    import numpy as np
    import torch
    from repro_torch.core import compression
    from repro_torch.kernels.quantize import ops as quant_ops
    from repro_torch.kernels.quantize import ref as quant_ref
    q, s = quant_ops.quantize(x, block)
    q_ref, s_ref = quant_ref.quantize(x, block)
    torch.cuda.synchronize()
    if not (bits_equal(q, q_ref) and bits_equal(s, s_ref)):
        raise AssertionError(f"quantize {what}: kernel != plain")
    del q_ref, s_ref
    q_np, s_np = compression.quantize_int8_batch(x.cpu().numpy(), block)
    if not (np.array_equal(q.cpu().numpy(), q_np)
            and bits_equal(s.cpu(), torch.from_numpy(s_np))):
        raise AssertionError(f"quantize {what}: kernel != numpy host path")
    return q, s


def check_quantize(dev, record, parent) -> None:
    """Phase 2 for quantize and dequantize at SHAPES["quantize"] (blocks of
    BLOCK) and QUANT_WIRE, then quantize at QUANT_LEAVES: each held bitwise
    against the plain version and numpy, its route printed, timed (under
    ``--parent`` beside the replaced kernel)."""
    import numpy as np
    import torch
    from repro_torch.core import compression
    from repro_torch.kernels.quantize import ops as quant_ops
    from repro_torch.kernels.quantize import ref as quant_ref

    shapes = {key: (r, n, BLOCK) for key, (r, n) in SHAPES["quantize"].items()}
    for key, (r, n, block) in dict(shapes, **QUANT_WIRE).items():
        if key != "large":
            x = torch.from_numpy(np.random.default_rng(2).standard_normal(
                (r, n)).astype(np.float32)).to(dev)
        else:
            gen = torch.Generator(device=dev).manual_seed(3)
            x = torch.randn((r, n), generator=gen, device=dev)
        q, s = _hold_quantize(x, block, f"{r}x{n}")
        deq = quant_ops.dequantize(q, s, n, block)
        deq_ref = quant_ref.dequantize(q, s, n, block)
        torch.cuda.synchronize()
        if not bits_equal(deq, deq_ref):
            raise AssertionError(f"dequantize {r}x{n}: kernel != plain")
        d_np = compression.dequantize_int8_batch(q.cpu().numpy(),
                                                 s.cpu().numpy(), n, block)
        if not bits_equal(deq.cpu(), torch.from_numpy(d_np)):
            raise AssertionError("dequantize: kernel != numpy host path")
        say(f"  quantize / dequantize {(r, n)} in blocks of {block}: kernel "
            f"== plain == numpy host path")
        _record_quantize(record, key, x, block, q, s, parent)
        _record_dequantize(record, key, q, s, n, block, deq)
    # The fleet path decodes int8 after topk: one client's kept values at
    # each tier's length (its error-feedback decode).
    for tier, k in TIER_K.items():
        x_np = np.random.default_rng(6).standard_normal(
            (1, k)).astype(np.float32)
        q_np, s_np = compression.quantize_int8_batch(x_np, BLOCK)
        q, s = torch.from_numpy(q_np).to(dev), torch.from_numpy(s_np).to(dev)
        deq = quant_ops.dequantize(q, s, k, BLOCK)
        if not bits_equal(deq.cpu(), torch.from_numpy(
                compression.dequantize_int8_batch(q_np, s_np, k, BLOCK))):
            raise AssertionError(f"dequantize 1x{k}: kernel != numpy")
        _record_dequantize(record, f"client_{tier}", q, s, k, BLOCK, deq)
    # The pod aggregation's rows: one leaf of each width.
    for key, (r, n, block) in QUANT_LEAVES.items():
        gen = torch.Generator(device=dev).manual_seed(r + n)
        x = torch.randn((r, n), generator=gen, device=dev)
        q, s = _hold_quantize(x, block, f"{r}x{n}")
        say(f"  quantize {(r, n)} in blocks of {block}: kernel == plain == "
            f"numpy host path")
        _record_quantize(record, key, x, block, q, s, parent, plain_calls=2)
        del x, q, s
        torch.cuda.empty_cache()


# Quantize's edge cases (rows, n, block, offset): n % 4 = 1, 2, 3 and 0
# over several rows (rows after the first start off the 16-byte grid:
# scalar loads), blocks of 1, 7 and 1000, rows past a grid's 65,535, x
# one float into its buffer (off the 16-byte grid), and block sizes that
# reach each kernel of ops.QUANT_KERNELS and the wide route: each over a
# few rows (the short route) and over more rows than the card's threads
# hold (narrow and row), with n % 4 = 1 (scalar loads) and with n % 4 = 0
# and a ragged last block (vector loads).
QUANT_EDGE_BLOCKS = (4, 7, 16, 32, 64, 128, 256, 512, 700, 1024, 1536,
                     2048, 3000, 4096, 5504, 8192, 10_000)


def _rows_past_the_card(block: int) -> int:
    """Rows of 3 blocks that need more threads than the card holds at one
    float4 unit a lane (up to 256 lanes a block): a call paced by its
    bytes, which takes the narrow or row route, not the short one."""
    spread = min(256, 1 << (-(-block // 4) - 1).bit_length())
    return 132 * 8 * 256 // (3 * spread) + 1


QUANT_EDGES = ([(3, 25_449, 1024, 0), (3, SLICE_N, 1024, 0),
                (3, 25_451, 1024, 0), (3, 25_452, 1024, 0), (2, 3, 1, 0),
                (5, 2999, 7, 0), (5, 3001, 1000, 0), (65_537, 9, 7, 0),
                (65_537, 64, 64, 0), (3, 4096, 1024, 1), (5, 2999, 7, 1),
                (4, 1600, 1600, 1)]
               + [(rows, 2 * b + 5, b, 0) for b in QUANT_EDGE_BLOCKS
                  for rows in (3, _rows_past_the_card(b))]
               + [(rows, 3 * b - 4, b, 0) for b in QUANT_EDGE_BLOCKS
                  for rows in (2, _rows_past_the_card(b))])


def check_quantize_edges(dev) -> None:
    """Quantize at QUANT_EDGES, bitwise against the plain version and
    numpy; every kernel of ops.QUANT_KERNELS, the wide route and both
    loads must be reached."""
    import numpy as np
    import torch
    from repro_torch.kernels.quantize import ops as quant_ops

    rng = np.random.default_rng(18)
    reached = set()
    for rows, n, block, offset in QUANT_EDGES:
        x_np = rng.standard_normal((rows, n)).astype(np.float32)
        x_np[:, ::97] *= 40.0                  # uneven block ranges
        buf = torch.zeros(rows * n + offset, device=dev)
        buf[offset:] = torch.from_numpy(x_np.reshape(-1)).to(dev)
        x = buf[offset:].view(rows, n)
        if offset and x.data_ptr() % 16 == 0:
            raise AssertionError("quantize edge: x on the grid")
        p = quant_ops.quantize_plan(rows, n, block,
                                    quant_ops.is_aligned(x, block))
        reached.add((p.route, p.lanes, p.units, p.vector))
        _hold_quantize(x, block, f"edge {(rows, n)} block {block} offset "
                       f"{offset}")
    kernels_hit = {(g, u) for route, g, u, _ in reached if route != "wide"}
    if (kernels_hit != set(quant_ops.QUANT_KERNELS)
            or {r[0] for r in reached} != {"short", "narrow", "row", "wide"}
            or {r[3] for r in reached if r[0] != "wide"} != {True, False}):
        raise AssertionError(f"quantize edges reached only {sorted(reached)}")
    say(f"  quantize edges ({len(QUANT_EDGES)} cases: n % 4 = 1, 2, 3 over "
        f"several rows, blocks 1, 7, 1000, each of the "
        f"{len(quant_ops.QUANT_KERNELS)} (lanes, units) kernels of the "
        f"short, narrow and row routes and the wide route by vector and "
        f"scalar loads, 65,537 rows, x one float off the 16-byte grid): "
        f"kernel == plain == numpy")


# Dequantize's edge cases (rows, n, block): rows >= 2 at n mod 4 = 1, 2, 3
# and 0 (rows after the first start off the 16-byte grid), the top-k tier
# lengths under int8(1024), blocks that are no multiple of 16 or 4, rows
# past a grid's 65,535, and codes whose base is off the 16-byte grid.
DEQUANT_EDGES = [(3, 25_449, 1024), (3, SLICE_N, 1024), (3, 25_451, 1024),
                 (3, 25_452, 1024), (4, 10_180, 1024), (4, 3817, 1024),
                 (4, 1018, 1024), (5, 3001, 1000), (5, 2999, 7),
                 (6, 4097, 512), (2, 3, 1), (65_537, 9, 7)]


def check_dequantize_edges(dev) -> None:
    """Dequantize at DEQUANT_EDGES, from host-made codes: bitwise against
    the plain version and numpy's dequantize_int8_batch; and (5, 2999, 7)
    again with the codes one row into a larger buffer (off the grid)."""
    import numpy as np
    import torch
    from repro_torch.core import compression
    from repro_torch.kernels.quantize import ops as quant_ops
    from repro_torch.kernels.quantize import ref as quant_ref

    rng = np.random.default_rng(17)
    cases = [(*c, False) for c in DEQUANT_EDGES] + [(5, 2999, 7, True)]
    for rows, n, block, offset in cases:
        x_np = rng.standard_normal((rows, n)).astype(np.float32)
        q_np, s_np = compression.quantize_int8_batch(x_np, block)
        q = torch.from_numpy(q_np).to(dev)
        if offset:                     # one row of 3003 codes further in
            buf = torch.zeros((rows + 1, q.shape[1]), dtype=torch.int8,
                              device=dev)
            buf[1:] = q
            q = buf[1:]
            if q.data_ptr() % 16 == 0:
                raise AssertionError("dequantize edge: codes on the grid")
        s = torch.from_numpy(s_np).to(dev)
        out = quant_ops.dequantize(q, s, n, block)
        want = torch.from_numpy(
            compression.dequantize_int8_batch(q_np, s_np, n, block))
        if not (bits_equal(out.cpu(), want) and bits_equal(
                quant_ref.dequantize(q, s, n, block).cpu(), want)):
            raise AssertionError(f"dequantize {(rows, n)} block {block}: "
                                 f"kernel != plain != numpy")
    say(f"  dequantize edges {DEQUANT_EDGES} and codes off the 16-byte "
        f"grid: kernel == plain == numpy")


def lm_fl_params() -> int:
    """Parameters of fl_train_lm --scale 100m (one client's delta)."""
    import torch
    from repro_torch import fl_train_lm
    from repro_torch.models import model as M
    from repro_torch.tree import tree_leaves
    dev = torch.device("cuda")
    params = M.init(fl_train_lm.model_config("100m"),
                    torch.Generator(device=dev).manual_seed(0), dev)
    n = sum(t.numel() for t in tree_leaves(params))
    del params
    torch.cuda.empty_cache()
    return n


def check_lm_fl_kernels(dev, record, parent=None) -> None:
    """fedavg, quantize and dequantize at fl_train_lm --scale 100m's
    shapes: the server's mean of 3 clients' deltas (3, N) and one
    client's int8 encode and decode (1, N); bitwise against the plain
    versions, timed in full (``record``, key ``lm_fl``)."""
    import torch
    from repro_torch.kernels.fedavg import ops as fedavg_ops
    from repro_torch.kernels.fedavg import ref as fedavg_ref
    from repro_torch.kernels.quantize import ops as quant_ops
    from repro_torch.kernels.quantize import ref as quant_ref

    n, k = lm_fl_params(), 3
    gen = torch.Generator(device=dev).manual_seed(16)
    stack = torch.randn((k, n), generator=gen, device=dev) * 1e-3
    w = torch.ones(k, device=dev)
    out = fedavg_ops.fedavg(stack, w)
    plain = fedavg_ref.fedavg(stack, w)
    torch.cuda.synchronize()
    if not bits_equal(out, plain):
        raise AssertionError(f"fedavg {k}x{n}: kernel != plain version")
    err = float((out - plain).abs().max())
    del plain
    say(f"  fedavg {(k, n)}: {_say_plan(stack, w)}; kernel == plain")
    record("fedavg", "lm_fl", (k, n), 4 * k * n + 4 * k + 4 * n, 2 * k * n,
           lambda: fedavg_ops.fedavg(stack, w),
           lambda: fedavg_ref.fedavg(stack, w),
           lambda: w @ stack, err)
    del out
    x = stack[:1].clone()
    del stack
    q, sc = quant_ops.quantize(x, BLOCK)
    q_ref, s_ref = quant_ref.quantize(x, BLOCK)
    deq = quant_ops.dequantize(q, sc, n, BLOCK)
    deq_ref = quant_ref.dequantize(q, sc, n, BLOCK)
    torch.cuda.synchronize()
    if not (bits_equal(q, q_ref) and bits_equal(sc, s_ref)
            and bits_equal(deq, deq_ref)):
        raise AssertionError(f"quantize/dequantize 1x{n}: kernel != plain")
    del q_ref, s_ref, deq_ref
    _record_quantize(record, "lm_fl", x, BLOCK, q, sc, parent)
    _record_dequantize(record, "lm_fl", q, sc, n, BLOCK, deq)
    del x, q, sc, deq
    torch.cuda.empty_cache()


def check_head_widths(dev, rows) -> None:
    """Flash attention and the mLSTM at the head widths of C1_FLASH and
    C1_MLSTM (zero-padded to a compiled width by the wrappers), against
    their plain versions at the true width, f32 at 2e-5 / 5e-4 and bf16
    in the bf16 bands (the mLSTM's row-scaled)."""
    import torch
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention import ref as flash_ref
    from repro_torch.kernels.mlstm import ops as mlstm_ops
    from repro_torch.kernels.mlstm import ref as mlstm_ref

    gen = torch.Generator(device=dev).manual_seed(32)
    for B, S, H, KV, hd, window, dname in C1_FLASH:
        dtype = getattr(torch, dname)
        q = torch.randn((B, S, H, hd), generator=gen, device=dev).to(dtype)
        k, v = (torch.randn((B, S, KV, hd), generator=gen,
                            device=dev).to(dtype) for _ in range(2))
        out = flash_ops.flash_attention(q, k, v, window=window)
        plain = flash_ref.flash_attention(q, k, v, window=window)
        torch.cuda.synchronize()
        band = LM_BANDS[dname]["flash_attention"]
        ok, err = _band_check(out, plain, band)
        ms = time_ms(lambda: flash_ops.flash_attention(q, k, v,
                                                       window=window))
        say(f"  flash_attention hd{hd} {dname} {(B, S, H, KV, hd)} window "
            f"{window}: max_abs_err {err} (band {band}), per call "
            f"{ms:.6f} ms")
        if not ok:
            raise AssertionError(f"flash_attention hd {hd} {dname}: kernel "
                                 f"outside the band, max |err| {err}")
        rows["flash_attention"][f"hd{hd}_{S}_{dname}"] = {
            "shape": [B, S, H, KV, hd, window], "ms": ms, "max_abs_err": err}
    for B, S, nh, dh, f_shift, dname in C1_MLSTM:
        dtype = getattr(torch, dname)
        q, k, v = (torch.randn((B, S, nh, dh), generator=gen,
                               device=dev).to(dtype) for _ in range(3))
        ig = torch.randn((B, S, nh), generator=gen, device=dev).to(dtype)
        fg = (torch.randn((B, S, nh), generator=gen, device=dev)
              + f_shift).to(dtype)
        out = mlstm_ops.mlstm(q, k, v, ig, fg)
        plain = mlstm_ref.mlstm_parallel(q, k, v, ig, fg)
        torch.cuda.synchronize()
        band = LM_BANDS[dname]["mlstm"]
        ok, err = _band_check(out, plain, band,
                              row_scale=dtype == torch.bfloat16)
        ms = time_ms(lambda: mlstm_ops.mlstm(q, k, v, ig, fg))
        say(f"  mlstm dh{dh} {dname} {(B, S, nh, dh)}: max_abs_err {err} "
            f"(band {band}{', row-scaled' if dname == 'bfloat16' else ''}), "
            f"per call {ms:.6f} ms")
        if not ok:
            raise AssertionError(f"mlstm dh {dh} {dname}: kernel outside "
                                 f"the band, max |err| {err}")
        rows["mlstm"][f"dh{dh}_{S}_{dname}"] = {
            "shape": [B, S, nh, dh], "ms": ms, "max_abs_err": err}
    torch.cuda.empty_cache()


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


def _gather_sector_bound(rec: dict, idx, n: int) -> None:
    """The gather's bound counted the way the card reads: whole 32-byte
    sectors of x.  The distinct sectors the indices touch, counted exactly
    from ``idx`` on the card (row-major x, rows of n floats from a base
    the allocator aligns to 512 bytes; idx increases along each row, so a
    new sector starts wherever the sector number changes), times 32, plus
    the indices read and the values written (8 bytes a kept element).
    Prints the kernel's device time as a share of both bounds; into
    ``rec``."""
    import torch
    rows, k = idx.shape
    first = torch.arange(rows, device=idx.device, dtype=torch.int64) * n
    sector = ((first[:, None] + idx.long()) // 8).reshape(-1)
    sectors = 1 + int((sector[1:] != sector[:-1]).sum())
    nbytes = 32 * sectors + 8 * rows * k
    bnd, _ = bound_ms(nbytes, 0)
    t = rec["device"]["ms"]
    rec.update(sector_bytes=nbytes, sectors=sectors,
               sector_bound_ms=bnd, sector_share=bnd / t,
               element_share=rec["bound_ms"] / t)
    say(f"    sectors of x the indices touch: {sectors} of "
        f"{-(-rows * n // 8)} ({sectors / -(-rows * n // 8):.4f}); sector "
        f"bound {nbytes} bytes, {bnd:.6f} ms: the kernel's device time "
        f"{t:.6f} ms reads {bnd / t:.4f} of it ({rec['bound_ms'] / t:.4f} "
        f"of the 12-byte-a-kept-element bound)")


def check_topk(dev, record, records, parent=None) -> None:
    """Phase 2 for the top-k gather and scatter kernels (``records``: what
    ``record`` fills)."""
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
        flag = torch.zeros(1, dtype=torch.int64, device=dev)
        stamp = topk_ops.GATHER_FLAGS.stamp()
        parent_fn = None
        if parent is not None and parent.has("topk_gather"):
            old = torch.empty_like(out)
            err = torch.empty(1, dtype=torch.int32, device=dev)
            parent.gather(x, idx, old, err)
            torch.cuda.synchronize()
            if not bits_equal(old, out) or int(err.item()):
                raise AssertionError(f"topk_gather {rows}x{n}->{k}: the "
                                     f"parent's kernel disagrees")
            parent_fn = lambda: parent.gather(x, idx, old, err)  # noqa
        # Reads idx and the kept values of x, writes the kept values.
        rec = record("topk_gather", key, (rows, n, k), 12 * rows * k, 0,
                     lambda: topk_ops.topk_gather(x, idx),
                     lambda: topk_ref.gather(x, idx),
                     lambda: torch.gather(x, 1, idx64),
                     float((out - plain).abs().max()),
                     launch_fn=lambda: topk_ops._launch_gather(
                         x, idx, buf, flag, stamp), parent_fn=parent_fn)
        say(f"    topk_gather {(rows, n, k)}: device {rec['device']['ms']:.6f}"
            f" ms, torch.gather {rec['device']['library_ms']:.6f} ms (the "
            f"kernel {rec['device']['ms'] / rec['device']['library_ms']:.3f}"
            f"x its time)")
        _gather_sector_bound(rec, idx, n)
    check_gather_flags(dev, parent)

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
        scratch = topk_ops.scatter_scratch(rows, dev)
        say(f"  topk_scatter {(rows, k, n)}: {topk_ops.scatter_tile(rows, n)}"
            f" columns a CTA")
        # Reads idx and vals, writes the whole dense output.
        record("topk_scatter", key, (rows, k, n),
               4 * rows * n + 8 * rows * k, 0,
               lambda: topk_ops.topk_scatter(idx, vals, n),
               lambda: topk_ref.scatter(idx, vals, n),
               lambda: torch.zeros((rows, n), device=dev).scatter_(
                   1, idx64, vals),
               float((out - plain).abs().max()),
               launch_fn=lambda: topk_ops._launch_scatter(
                   idx, vals, buf, scratch))


def graph_node_types(fn) -> list[str]:
    """The nodes of a CUDA graph captured (through the driver API) from
    ``fn()`` on a side stream: "kernel", "memset", "memcpy" or the
    driver's node type number."""
    import ctypes

    import torch
    cu = ctypes.CDLL("libcuda.so.1")

    def check(rc, what):
        if rc:
            raise AssertionError(f"{what}: CUresult {rc}")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    handle = ctypes.c_void_p(side.cuda_stream)
    graph = ctypes.c_void_p()
    with torch.cuda.stream(side):
        # CU_STREAM_CAPTURE_MODE_RELAXED
        check(cu.cuStreamBeginCapture_v2(handle, ctypes.c_int(2)),
              "cuStreamBeginCapture")
        try:
            fn()
        finally:
            check(cu.cuStreamEndCapture(handle, ctypes.byref(graph)),
                  "cuStreamEndCapture")
    try:
        count = ctypes.c_size_t(0)
        check(cu.cuGraphGetNodes(graph, None, ctypes.byref(count)),
              "cuGraphGetNodes")
        nodes = (ctypes.c_void_p * count.value)()
        check(cu.cuGraphGetNodes(graph, nodes, ctypes.byref(count)),
              "cuGraphGetNodes")
        names = {0: "kernel", 1: "memcpy", 2: "memset"}
        out = []
        for node in nodes:
            kind = ctypes.c_int(-1)
            check(cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                        ctypes.byref(kind)),
                  "cuGraphNodeGetType")
            out.append(names.get(kind.value, str(kind.value)))
        return out
    finally:
        check(cu.cuGraphDestroy(graph), "cuGraphDestroy")


def check_gather_flags(dev, parent=None) -> None:
    """The gather's bad-index contract without a zeroed flag: the calls
    good, bad, good, bad, bad on one stream raise exactly at the bad ones
    (a stale stamp raises nothing; a bad call right after another
    raises), each good call's values equal to the plain version's; and a
    call is one node of a CUDA graph, a kernel (under ``--parent`` the
    replaced launcher's nodes are printed beside it)."""
    import numpy as np
    import torch
    from repro_torch.kernels.topk import ops as topk_ops
    from repro_torch.kernels.topk import ref as topk_ref

    rng = np.random.default_rng(23)
    x = torch.from_numpy(rng.standard_normal((4, SLICE_N)).astype(
        np.float32)).to(dev)
    good = np.stack([np.sort(rng.choice(SLICE_N, 1018, replace=False))
                     for _ in range(4)]).astype(np.int32)
    bad = good.copy()
    bad[2, 500] = SLICE_N
    idx = {"good": torch.from_numpy(good).to(dev),
           "bad": torch.from_numpy(bad).to(dev)}
    raised = []
    for kind in ("good", "bad", "good", "bad", "bad"):
        try:
            out = topk_ops.topk_gather(x, idx[kind])
        except IndexError:
            raised.append(True)
            continue
        raised.append(False)
        if not bits_equal(out, topk_ref.gather(x, idx[kind])):
            raise AssertionError("topk_gather after a bad call: kernel != "
                                 "plain")
    if raised != [False, True, False, True, True]:
        raise AssertionError(f"topk_gather good, bad, good, bad, bad "
                             f"raised {raised}")
    out = torch.empty((4, 1018), device=dev)
    flag = torch.zeros(1, dtype=torch.int64, device=dev)
    stamp = topk_ops.GATHER_FLAGS.stamp()
    torch.cuda.synchronize()
    nodes = graph_node_types(lambda: [topk_ops._launch_gather(
        x, idx["good"], out, flag, stamp) for _ in range(3)])
    if nodes != ["kernel"] * 3:
        raise AssertionError(f"topk_gather: 3 calls captured as {nodes}")
    old = ""
    if parent is not None and parent.has("topk_gather"):
        err = torch.empty(1, dtype=torch.int32, device=dev)
        old = graph_node_types(
            lambda: parent.gather(x, idx["good"], out, err))
        old = f" (the parent's launcher: {old})"
    say(f"  topk_gather bad-index sequence good, bad, good, bad, bad: raised "
        f"{raised}, each good call == plain; 3 calls captured in a CUDA "
        f"graph: {nodes}{old}")


def _scatter_holds(dev, label, idx_np, vals_np, n) -> None:
    """The scatter kernel on host-made (idx, vals), bitwise against the
    plain version and numpy's sequential assignment (last write wins)."""
    import numpy as np
    import torch
    from repro_torch.kernels.topk import ops as topk_ops
    from repro_torch.kernels.topk import ref as topk_ref
    rows, k = idx_np.shape
    idx = torch.from_numpy(idx_np).to(dev)
    vals = torch.from_numpy(vals_np).to(dev)
    dense = np.zeros((rows, n), np.float32)
    dense[np.repeat(np.arange(rows), k), idx_np.reshape(-1)] = \
        vals_np.reshape(-1)
    want = torch.from_numpy(dense)
    got = topk_ops.topk_scatter(idx, vals, n).cpu()
    if not (bits_equal(got, want)
            and bits_equal(topk_ref.scatter(idx, vals, n).cpu(), want)):
        raise AssertionError(f"topk_scatter {label}: kernel != plain != "
                             f"numpy")


def check_topk_edges(dev) -> None:
    """The scatter's edge cases: duplicates, unordered rows spanning many
    tiles beside increasing ones, every entry in one tile, K = 0, widths
    off the 16-byte grid and off the tile, rows past a grid's 65,535 and
    bad indices (which must raise)."""
    import numpy as np
    import torch
    from repro_torch.kernels.topk import ops as topk_ops

    rng = np.random.default_rng(8)

    def inc(k, lo, hi):                 # k sorted distinct in [lo, hi)
        return np.sort(rng.choice(np.arange(lo, hi), k, replace=False))

    def values(shape):
        return rng.standard_normal(shape).astype(np.float32)

    # Duplicate indices resolve last-wins, like the reference's loop.
    _scatter_holds(dev, "duplicates", np.array([[3, 3, 7], [0, 5, 0]],
                                               np.int32),
                   np.array([[1., 2., 3.], [4., 5., 6.]], np.float32), 10)
    # Eight rows of 5000 over 30,000 columns (30 tiles): increasing rows
    # beside unordered rows with duplicates all over the row, a sorted row
    # with one repeated index, a descending row, unordered duplicates over
    # tiles 1-3 and inside tile 2.
    n, t = 30_000, topk_ops.scatter_tile(8, 30_000)
    repeat = inc(5000, 0, n)
    repeat[2500] = repeat[2499]
    mixed = np.stack([
        inc(5000, 0, n), rng.integers(0, n, 5000), inc(5000, 0, n), repeat,
        inc(5000, 0, n)[::-1], rng.integers(t, 4 * t, 5000),
        inc(5000, 0, n), rng.integers(2 * t, 3 * t, 5000)]).astype(np.int32)
    _scatter_holds(dev, "mixed rows", mixed, values(mixed.shape), n)
    # Every entry of a row in one tile: the first, a middle and the last.
    n = SLICE_N
    t = topk_ops.scatter_tile(3, n)
    last = (n - 1) // t * t
    one = np.stack([inc(800, 0, t), inc(800, 5 * t, 6 * t),
                    inc(800, last, n)]).astype(np.int32)
    _scatter_holds(dev, "one tile", one, values(one.shape), n)
    # K = 0 rows, and widths off the 16-byte grid and off the tile.
    _scatter_holds(dev, "K = 0", np.zeros((4, 0), np.int32),
                   np.zeros((4, 0), np.float32), n)
    for rows, n, k in ((5, 25_451, 3817), (5, 10_181, 1527), (3, 3, 2),
                       (2, 1, 1)):
        ragged = np.stack([inc(k, 0, n) for _ in range(rows)]).astype(
            np.int32)
        _scatter_holds(dev, f"n={n}", ragged, values(ragged.shape), n)
    # Rows past 65,535 (the grid's y limit), one of them unordered.
    many = np.stack([inc(3, 0, 13) for _ in range(70_000)]).astype(np.int32)
    many[-1] = [5, 2, 5]
    _scatter_holds(dev, "70,000 rows", many, values(many.shape), 13)
    # Bad indices set the flag, and the wrapper raises: rows short enough
    # for each CTA to see all of them (1018), and longer ones (a ticket).
    for bad_row, bad, k in ((2, SLICE_N, 1018), (0, -1, 3817),
                            (3, 1 << 30, 10_180)):
        idx_np = np.stack([inc(k, 0, SLICE_N) for _ in range(4)])
        idx_np[bad_row, 500] = bad
        try:
            topk_ops.topk_scatter(torch.from_numpy(idx_np.astype(
                np.int32)).to(dev), torch.from_numpy(values(idx_np.shape)).to(
                dev), SLICE_N)
        except IndexError:
            continue
        raise AssertionError(f"topk_scatter: index {bad} did not raise")
    say("  topk_scatter edges (duplicates, unordered rows over 30 tiles, "
        "one tile, K = 0, n = 25451 / 10181 / 3 / 1, 70,000 rows): kernel "
        "== plain == numpy; bad indices raise")


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


def _kept_pairs(S: int, T: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask keeps: key t < T for query s, t <= s if
    causal, s - t < window if window > 0."""
    total = 0
    for q in range(S):
        hi = min(q, T - 1) if causal else T - 1
        lo = max(0, q - window + 1) if window > 0 else 0
        total += max(0, hi - lo + 1)
    return total


def _band_check(got, want, band: float,
                row_scale: bool = False) -> tuple[bool, float]:
    """(every |got - want| <= band * (1 + |want|), max |got - want|);
    with ``row_scale`` the bound is band * (1 + the largest |want| in the
    element's row, the last axis)."""
    d = (got.float() - want.float()).abs()
    scale = want.float().abs()
    if row_scale:
        scale = scale.amax(dim=-1, keepdim=True)
    return bool((d <= band * (1 + scale)).all()), float(d.max())


def _mlstm_kernel_alone(rec, q, k, v, ig, fg, flops, nbytes) -> None:
    """The tensor-core mLSTM kernel alone on the device: the bare launch
    on gate terms formed once (the wrapper's record times them too); into
    ``rec``."""
    import torch
    from repro_torch.kernels.mlstm import ops as mlstm_ops

    lib = mlstm_ops._lib()
    g, m, floor = mlstm_ops.gate_terms(ig, fg)
    out = torch.empty_like(v)
    B, S, nh, dh = q.shape
    bnd, _ = bound_ms(nbytes, flops, PEAK_BF16_FLOPS)
    t = rec["kernel_alone_ms"] = device_ms(lambda: lib.mlstm_wgmma_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), m.data_ptr(),
        floor.data_ptr(), out.data_ptr(), B, S, nh, dh, dh ** -0.5,
        torch.cuda.current_stream().cuda_stream))
    say(f"    kernel alone: device {t:.6f} ms, {flops / t / 1e9:.1f} TFLOP/s "
        f"({bnd / t:.4f} of the bound)")
    del g, m, floor, out


def check_lm_kernels(dev, record, rows) -> None:
    """Phase 2 for the LM kernels (flash attention, chunkwise mLSTM) at
    the serving paths' shapes and at a prompt no tile divides, in bf16 and
    f32, against their plain versions; the path shapes in bf16 are timed
    in full (``record``), the others per call."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention import ref as flash_ref
    from repro_torch.kernels.mlstm import ops as mlstm_ops
    from repro_torch.kernels.mlstm import ref as mlstm_ref

    gen = torch.Generator(device=dev).manual_seed(9)
    # gemma3-12b prefill: q (2, P, 16, 256), k/v (2, P, 8, 256); local
    # layers window 1024, global layers none.
    B, H, KV, hd = 2, 16, 8, 256
    for S in (LM_PATHS["gemma3-12b"]["prompt"], TAIL_S):
        for window in (1024, 0):
            for dtype in (torch.bfloat16, torch.float32):
                dname = str(dtype).removeprefix("torch.")
                key = ("local" if window else "global") + (
                    "" if S == LM_PATHS["gemma3-12b"]["prompt"] else f"_{S}")
                q = torch.randn((B, S, H, hd), generator=gen,
                                device=dev).to(dtype)
                k, v = (torch.randn((B, S, KV, hd), generator=gen,
                                    device=dev).to(dtype) for _ in range(2))
                out = flash_ops.flash_attention(q, k, v, window=window)
                plain = flash_ref.flash_attention(q, k, v, window=window)
                torch.cuda.synchronize()
                ok, err = _band_check(out, plain, LM_BANDS[dname][
                    "flash_attention"])
                say(f"  flash_attention {key} {dname} {(B, S, H, KV, hd)}: "
                    f"max_abs_err {err} (band {LM_BANDS[dname]['flash_attention']})")
                if not ok:
                    raise AssertionError(f"flash_attention {key} {dname}: "
                                         f"kernel outside the band, max "
                                         f"|err| {err}")
                esize = q.element_size()
                nbytes = esize * (2 * B * S * H * hd + 2 * B * S * KV * hd)
                flops = 4 * hd * B * H * _kept_pairs(S, S, True, window)
                peak = (PEAK_BF16_FLOPS if dtype == torch.bfloat16
                        else PEAK_F32_FLOPS)
                if dtype == torch.bfloat16 and S == LM_PATHS[
                        "gemma3-12b"]["prompt"]:
                    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
                    if window:
                        pos = torch.arange(S, device=dev)
                        band = ((pos[None] <= pos[:, None])
                                & (pos[:, None] - pos[None] < window))
                        lib = (lambda: F.scaled_dot_product_attention(
                            qt, kt, vt, attn_mask=band, enable_gqa=True))
                    else:
                        lib = (lambda: F.scaled_dot_product_attention(
                            qt, kt, vt, is_causal=True, enable_gqa=True))
                    record("flash_attention", key, (B, S, H, KV, hd, window),
                           nbytes, flops,
                           lambda: flash_ops.flash_attention(
                               q, k, v, window=window),
                           lambda: flash_ref.flash_attention(
                               q, k, v, window=window), lib, err,
                           peak_flops=peak)
                else:
                    ms = time_ms(lambda: flash_ops.flash_attention(
                        q, k, v, window=window))
                    bnd, by = bound_ms(nbytes, flops, peak)
                    say(f"    per call {ms:.6f} ms, {flops / ms / 1e9:.1f} "
                        f"TFLOP/s ({bnd / ms:.4f} of the bound), bound "
                        f"{bnd:.6f} ms ({by})")
                    rows.setdefault("flash_attention", {})[
                        f"{key}_{dname}"] = {
                        "shape": [B, S, H, KV, hd, window], "ms": ms,
                        "bound_ms": bnd, "bound_by": by, "bytes": nbytes,
                        "flops": flops, "max_abs_err": err}
                del q, k, v, out, plain
    # The tensor-core kernel's other instantiations (bf16 at hd 64, 128):
    # a prompt no tile divides, a window of 1000 that binds, GQA.
    B, S, H, KV, window = 1, TAIL_S, 4, 2, 1000
    tol = LM_BANDS["bfloat16"]["flash_attention"]
    for hd in (64, 128):
        q = torch.randn((B, S, H, hd), generator=gen,
                        device=dev).to(torch.bfloat16)
        k, v = (torch.randn((B, S, KV, hd), generator=gen,
                            device=dev).to(torch.bfloat16) for _ in range(2))
        out = flash_ops.flash_attention(q, k, v, window=window)
        plain = flash_ref.flash_attention(q, k, v, window=window)
        torch.cuda.synchronize()
        ok, err = _band_check(out, plain, tol)
        say(f"  flash_attention tail_hd{hd} bfloat16 {(B, S, H, KV, hd)} "
            f"window {window}: max_abs_err {err} (band {tol})")
        if not ok:
            raise AssertionError(f"flash_attention hd {hd} bfloat16: kernel "
                                 f"outside the band, max |err| {err}")
        nbytes = 2 * (2 * B * S * H * hd + 2 * B * S * KV * hd)
        flops = 4 * hd * B * H * _kept_pairs(S, S, True, window)
        ms = time_ms(lambda: flash_ops.flash_attention(q, k, v,
                                                       window=window))
        bnd, by = bound_ms(nbytes, flops, PEAK_BF16_FLOPS)
        say(f"    per call {ms:.6f} ms, {flops / ms / 1e9:.1f} TFLOP/s "
            f"({bnd / ms:.4f} of the bound), bound {bnd:.6f} ms ({by})")
        rows.setdefault("flash_attention", {})[f"tail_hd{hd}_bfloat16"] = {
            "shape": [B, S, H, KV, hd, window], "ms": ms, "bound_ms": bnd,
            "bound_by": by, "bytes": nbytes, "flops": flops,
            "max_abs_err": err}
        del q, k, v, out, plain

    # xlstm-350m prefill: q/k/v (4, P, 4, 512) (dh = 2 * d_model / nh),
    # gate logits (4, P, 4).  bf16 takes the tensor-core kernel, f32 the
    # CUDA-core one.
    B, nh, dh = 4, 4, 512
    for S in (LM_PATHS["xlstm-350m"]["prompt"], TAIL_S):
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).removeprefix("torch.")
            key = "path" if S == LM_PATHS["xlstm-350m"]["prompt"] else \
                f"tail_{S}"
            q, k, v = (torch.randn((B, S, nh, dh), generator=gen,
                                   device=dev).to(dtype) for _ in range(3))
            ig = torch.randn((B, S, nh), generator=gen, device=dev).to(dtype)
            fg = (torch.randn((B, S, nh), generator=gen, device=dev)
                  + 2.0).to(dtype)
            out = mlstm_ops.mlstm(q, k, v, ig, fg)
            plain = mlstm_ref.mlstm_parallel(q, k, v, ig, fg)
            torch.cuda.synchronize()
            ok, err = _band_check(out, plain, LM_BANDS[dname]["mlstm"],
                                  row_scale=dtype == torch.bfloat16)
            # Context for the bf16 band: each against the f32 plain
            # version on the same (bf16-valued) inputs, and the kernel
            # against the plain version in its own form (the stabiliser
            # known up front, so s rounds to bf16 under the same one).
            exact = mlstm_ref.mlstm_parallel(
                *(t.float() for t in (q, k, v, ig, fg)))
            known = ""
            if dtype == torch.bfloat16:
                form = mlstm_ref.mlstm_known_stabiliser(
                    q, k, v, *mlstm_ops.gate_terms(ig, fg))
                known = (f", against the known-stabiliser plain form "
                         f"{float((out.float() - form.float()).abs().max())}")
                del form
            say(f"  mlstm {key} {dname} {(B, S, nh, dh)}: max_abs_err "
                f"{err} (band {LM_BANDS[dname]['mlstm']}); against f32: "
                f"kernel {float((out.float() - exact).abs().max())}, plain "
                f"{float((plain.float() - exact).abs().max())}, max |out| "
                f"{float(exact.abs().max())}{known}")
            del exact
            if not ok:
                raise AssertionError(f"mlstm {key} {dname}: kernel outside "
                                     f"the band, max |err| {err}")
            esize = q.element_size()
            nbytes = esize * (4 * B * S * nh * dh + 2 * B * S * nh)
            flops = 4 * dh * B * nh * _kept_pairs(S, S, True, 0)
            peak = (PEAK_BF16_FLOPS if dtype == torch.bfloat16
                    else PEAK_F32_FLOPS)
            if dtype == torch.bfloat16:
                record("mlstm", key, (B, S, nh, dh), nbytes, flops,
                       lambda: mlstm_ops.mlstm(q, k, v, ig, fg),
                       lambda: mlstm_ref.mlstm_parallel(q, k, v, ig, fg),
                       None, err, peak_flops=peak)
                _mlstm_kernel_alone(rows["mlstm"][key], q, k, v, ig, fg,
                                    flops, nbytes)
            else:
                ms = time_ms(lambda: mlstm_ops.mlstm(q, k, v, ig, fg))
                bnd, by = bound_ms(nbytes, flops, peak)
                say(f"    per call {ms:.6f} ms, bound {bnd:.6f} ms ({by})")
                rows.setdefault("mlstm", {})[f"{key}_{dname}"] = {
                    "shape": [B, S, nh, dh], "ms": ms, "bound_ms": bnd,
                    "bound_by": by, "bytes": nbytes, "flops": flops,
                    "max_abs_err": err}
            del q, k, v, ig, fg, out, plain
    # The tensor-core route's edges: S under one tile and one row either
    # side of a tile's end, and a q base off the 16-byte grid (the wrapper
    # copies it for TMA).
    B, tol = 2, LM_BANDS["bfloat16"]["mlstm"]
    for S in (1, 63, 65, 200):
        q, k, v = (torch.randn((B, S, nh, dh), generator=gen,
                               device=dev).to(torch.bfloat16)
                   for _ in range(3))
        ig = torch.randn((B, S, nh), generator=gen,
                         device=dev).to(torch.bfloat16)
        fg = (torch.randn((B, S, nh), generator=gen, device=dev)
              + 2.0).to(torch.bfloat16)
        q_off = torch.empty(q.numel() + 8, dtype=q.dtype,
                            device=dev)[1:1 + q.numel()].view_as(q)
        q_off.copy_(q)
        plain = mlstm_ref.mlstm_parallel(q, k, v, ig, fg)
        errs = {}
        for name, qq in (("", q), (", q off the 16-byte grid", q_off)):
            ok, errs[name] = _band_check(mlstm_ops.mlstm(qq, k, v, ig, fg),
                                         plain, tol, row_scale=True)
            if not ok:
                raise AssertionError(f"mlstm edge S={S}{name}: kernel "
                                     f"outside the band, max |err| "
                                     f"{errs[name]}")
        say(f"  mlstm edge_{S} bfloat16 {(B, S, nh, dh)}: max_abs_err "
            + "".join(f"{name} {e}" for name, e in errs.items())
            + f" (band {tol})")
        rows["mlstm"][f"edge_{S}_bfloat16"] = {
            "shape": [B, S, nh, dh], "max_abs_err": max(errs.values())}
        del q, k, v, ig, fg, q_off, plain
    torch.cuda.empty_cache()


def check_family_attention(dev, rows) -> None:
    """Phase 2 for flash attention at the layer shapes of phase 10's
    families (FAMILY_ATTENTION), in bf16 (the tensor-core kernel) and f32
    (the CUDA-core one) against the plain version; bf16 timed per call and
    on the device beside its bound and SDPA's device time on the same
    inputs (the yardstick: the port never calls it)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention import ref as flash_ref

    gen = torch.Generator(device=dev).manual_seed(10)
    for key, (B, S, T, H, KV, hd, causal, window) in FAMILY_ATTENTION.items():
        q = torch.randn((B, S, H, hd), generator=gen, device=dev)
        k, v = (torch.randn((B, T, KV, hd), generator=gen, device=dev)
                for _ in range(2))
        flops = 4 * hd * B * H * _kept_pairs(S, T, causal, window)
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).removeprefix("torch.")
            qd, kd, vd = (t.to(dtype) for t in (q, k, v))

            def kernel():
                return flash_ops.flash_attention(qd, kd, vd, causal=causal,
                                                 window=window)
            out = kernel()
            plain = flash_ref.flash_attention(qd, kd, vd, causal=causal,
                                              window=window)
            torch.cuda.synchronize()
            band = LM_BANDS[dname]["flash_attention"]
            ok, err = _band_check(out, plain, band)
            say(f"  flash_attention {key} {dname} (B, S, T, H, KV, hd) "
                f"{(B, S, T, H, KV, hd)} causal {causal} window {window}: "
                f"max_abs_err {err} (band {band})")
            if not ok:
                raise AssertionError(f"flash_attention {key} {dname}: "
                                     f"kernel outside the band, max |err| "
                                     f"{err}")
            nbytes = qd.element_size() * (2 * B * S * H * hd
                                          + 2 * B * T * KV * hd)
            peak = (PEAK_BF16_FLOPS if dtype == torch.bfloat16
                    else PEAK_F32_FLOPS)
            bnd, by = bound_ms(nbytes, flops, peak)
            rec = {"shape": [B, S, T, H, KV, hd, int(causal), window],
                   "ms": time_ms(kernel), "bound_ms": bnd, "bound_by": by,
                   "bytes": nbytes, "flops": flops, "max_abs_err": err}
            if dtype == torch.bfloat16:
                qt, kt, vt = (t.transpose(1, 2) for t in (qd, kd, vd))
                mask = None
                if window:
                    pos = torch.arange(S, device=dev)
                    mask = ((pos[None] <= pos[:, None])
                            & (pos[:, None] - pos[None] < window))
                rec["device_ms"] = device_ms(kernel)
                rec["library_ms"] = device_ms(
                    lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, attn_mask=mask,
                        is_causal=causal and mask is None, enable_gqa=True))
                say(f"    per call {rec['ms']:.6f} ms; device "
                    f"{rec['device_ms']:.6f} ms, "
                    f"{flops / rec['device_ms'] / 1e9:.1f} TFLOP/s "
                    f"({bnd / rec['device_ms']:.4f} of the bound {bnd:.6f} "
                    f"ms, {by}); SDPA device {rec['library_ms']:.6f} ms")
            else:
                say(f"    per call {rec['ms']:.6f} ms, bound {bnd:.6f} ms "
                    f"({by})")
            rows.setdefault("flash_attention", {})[f"{key}_{dname}"] = rec
            del qd, kd, vd, out, plain
        del q, k, v
    torch.cuda.empty_cache()


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


# --------------------------------------------------------------------------
# Phases 6-7: LM serving at full width
# --------------------------------------------------------------------------
def _rel_l2(got, want) -> float:
    import torch
    got, want = got.float(), want.float()
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want))


def _top1(got, want) -> tuple[bool, int]:
    """Whether ``got``'s top-1 token equals ``want``'s on every row whose
    top-2 margin in ``want`` exceeds the largest |got - want|; and how many
    rows that is."""
    import torch
    err = float((got - want).abs().max())
    top2 = torch.topk(want, 2, dim=-1).values
    rows = (top2[:, 0] - top2[:, 1]) > err
    agree = got.argmax(-1) == want.argmax(-1)
    return bool(agree[rows].all()), int(rows.sum())


def _state_errors(cache, plain) -> dict:
    """Relative L2 error of each layer's K and V (transformer) or of each
    recurrent state (xLSTM), worst layer per key."""
    import torch
    out = {}
    for key, val in cache.items():
        if not torch.is_tensor(val):
            continue
        if key in ("k", "v"):
            out[key] = max(_rel_l2(val[i], plain[key][i])
                           for i in range(val.shape[0]))
        else:
            out[key] = _rel_l2(val, plain[key])
    return out


def _device_profile(label: str, fn, kernel: str) -> dict:
    """Run ``fn()`` once under ``torch.profiler`` and print where the card's
    time went: the wall time (profiler overhead included), the device busy
    time (kernels and copies on the card; one stream, so they do not
    overlap), its share of the wall, the kernel count, the five costliest
    kernels, and the time and share of the port's kernels whose names
    contain ``kernel``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    # Device activity only: the host's operator events would triple the
    # records (the xLSTM prefill alone launches about 180,000 kernels)
    # and the profiler's processing time with them.
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    launches = sum(e.count for e in rows)
    top = sorted(rows, key=lambda e: -e.self_device_time_total)[:5]
    out = {"wall_s": wall, "device_busy_ms": busy_ms,
           "idle_share": 1 - busy_ms / 1e3 / wall, "device_ops": launches,
           "top": {e.key[:60]: e.self_device_time_total / 1e3 for e in top}}
    say(f"  {label} under the profiler: wall {wall:.6f} s, device busy "
        f"{busy_ms:.3f} ms (idle share {out['idle_share']:.4f}), "
        f"{launches} kernels and copies; top: {json.dumps(out['top'])}")
    mine = [e for e in rows if kernel in e.key]
    mine_ms = sum(e.self_device_time_total for e in mine) / 1e3
    say(f"    {kernel} kernels: {mine_ms:.3f} ms over "
        f"{sum(e.count for e in mine)} launches, "
        f"{mine_ms / busy_ms:.4f} of the busy time")
    return out


def _mlstm_layers(cfg, params, prompt) -> list[tuple[float, float]]:
    """Layer by layer through the xLSTM prefill, each mLSTM layer fed the
    plain route's input: (kernel vs plain, plain vs its float32 twin)
    relative L2 of the layer's mLSTM output."""
    import torch
    from repro_torch.kernels.mlstm import ops as mlstm_ops
    from repro_torch.kernels.mlstm import ref as mlstm_ref
    from repro_torch.models import layers as L
    from repro_torch.models import xlstm as X

    d, di, nh, dh = X._dims(cfg)
    G, M = X._groups(cfg)
    out = []
    with torch.no_grad():
        x = L.embed_tokens(params["embed"], prompt)
        for g in range(G):
            for m in range(M):
                lp = X._group_params(params, g, m)
                z, *qkvif = X._mlstm_inputs(x, lp)
                plain = mlstm_ref.mlstm_parallel(*qkvif)
                exact = mlstm_ref.mlstm_parallel(*(t.float() for t in qkvif))
                out.append((_rel_l2(mlstm_ops.mlstm(*qkvif), plain),
                            _rel_l2(plain, exact)))
                x = X._mlstm_out(x, plain, z, lp, di)
            x, _ = X.slstm_block(x, X._group_params(params, g), cfg)
    return out


def _cast_tree(tree: dict, dtype) -> dict:
    return {k: _cast_tree(v, dtype) if isinstance(v, dict) else v.to(dtype)
            for k, v in tree.items()}


def _lm_holds(cfg, params, prompt, logits, prefill_cache) -> dict:
    """Holds (a)-(c) of one prefill (``logits``, ``prefill_cache``): (a)
    the same prefill with the kernel's plain version, (b) a prefill of the
    first P-1 tokens plus one decode step, (c) top-1 agreement of both."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T

    with torch.no_grad():
        lg_plain, cache_plain = M.make_prefill_step(cfg, attn_impl="plain")(
            params, {"tokens": prompt})
        states = _state_errors(prefill_cache, cache_plain)
        del cache_plain
        _, cache_b = M.make_prefill_step(cfg)(params,
                                              {"tokens": prompt[:, :-1]})
        if cfg.family == "dense":
            cache_b = T.grow_cache(cache_b, prompt.shape[1])
        lg_b, _ = M.make_decode_step(cfg)(params, cache_b, prompt[:, -1:])
        del cache_b
    top_a, rows_a = _top1(logits, lg_plain)
    top_b, rows_b = _top1(lg_b, logits)
    return {"rel_l2_a": _rel_l2(logits, lg_plain), "states_a": states,
            "rel_l2_b": _rel_l2(lg_b, logits), "top1_a": top_a,
            "rows_a": rows_a, "top1_b": top_b, "rows_b": rows_b,
            "plain_logits": lg_plain}


def _say_holds(tag: str, h: dict, logit_hold: float, state_hold) -> list:
    """Print one dtype's holds; return the failures."""
    states = {k: float(f"{v:.3e}") for k, v in h["states_a"].items()}
    n = len(h["plain_logits"])
    say(f"  {tag} (a) kernel vs plain prefill: logits rel L2 "
        f"{h['rel_l2_a']:.3e} (hold {logit_hold:.3e}); worst state rel L2 "
        f"{json.dumps(states)} (hold {state_hold:.3e})")
    say(f"  {tag} (b) prefill of P-1 + one decode step vs prefill: logits "
        f"rel L2 {h['rel_l2_b']:.3e} (hold {logit_hold:.3e})")
    say(f"  {tag} (c) top-1 agrees: (a) {h['top1_a']} on {h['rows_a']}/{n} "
        f"rows, (b) {h['top1_b']} on {h['rows_b']}/{n} rows whose top-2 "
        f"margin exceeds the error")
    fails = []
    if h["rel_l2_a"] > logit_hold:
        fails.append(f"{tag} (a) logits rel L2 {h['rel_l2_a']}")
    fails += [f"{tag} (a) {k} rel L2 {v}" for k, v in h["states_a"].items()
              if v > state_hold]
    if h["rel_l2_b"] > logit_hold:
        fails.append(f"{tag} (b) logits rel L2 {h['rel_l2_b']}")
    if not (h["top1_a"] and h["top1_b"]):
        fails.append(f"{tag} (c) top-1 disagrees")
    return fails


def run_lm_path(arch: str) -> tuple[dict, dict]:
    """Serve ``arch`` at full width on the card: seeded bf16 parameters,
    one prefill through ``make_prefill_step`` (the kernels), then
    GEN_STEPS greedy decode steps from its cache or state; launch counts
    zeroed just before and read just after.  Then the holds of
    :func:`_lm_holds` (and, with ``f32_twin``, on a float32 copy too).
    Returns the path's launch counts and its numbers."""
    import dataclasses

    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T

    spec = LM_PATHS[arch]
    cfg = get_config(arch)
    dev = torch.device("cuda")
    B, P = spec["batch"], spec["prompt"]
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = M.init(cfg, gen, dev)
    prompt = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                           device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for group in (params, params.get("layers", {}),
                                          params.get("mlstm", {}),
                                          params.get("slstm", {}))
                   for t in group.values() if torch.is_tensor(t))
    say(f"  {arch}: {cfg.num_layers} layers, d_model {cfg.d_model}, vocab "
        f"{cfg.vocab_size} (padded {cfg.padded_vocab}), {n_params} "
        f"parameters in {cfg.dtype}, init {time.perf_counter() - t0:.3f} s")
    prefill = M.make_prefill_step(cfg)
    decode = M.make_decode_step(cfg)
    torch.cuda.reset_peak_memory_stats()
    steps = []
    with torch.no_grad():
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        logits, cache = prefill(params, {"tokens": prompt})
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        peak_prefill_gb = torch.cuda.max_memory_allocated() / 1e9
        prefill_cache = cache            # decode writes only into copies
        if cfg.family == "dense":                  # + 2 profiled steps
            cache = T.grow_cache(cache, P + GEN_STEPS + 2)
        tok = logits.argmax(-1, keepdim=True)
        toks = [tok]
        for _ in range(GEN_STEPS):
            t0 = time.perf_counter()
            step_logits, cache = decode(params, cache, tok)
            tok = step_logits.argmax(-1, keepdim=True)
            torch.cuda.synchronize()
            steps.append(time.perf_counter() - t0)
            toks.append(tok)
        counts = dict(kernels.launch_counts)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    tokens = torch.cat(toks, dim=1).cpu()
    say(f"  prefill B={B} P={P}: {t_prefill:.6f} s "
        f"({B * P / t_prefill:.1f} tok/s); {GEN_STEPS} greedy steps: "
        f"{sum(steps):.6f} s (first {steps[0] * 1e3:.3f} ms, median "
        f"{statistics.median(steps) * 1e3:.3f} ms/step); peak memory "
        f"{peak_gb:.3f} GB ({peak_prefill_gb:.3f} GB just after the "
        f"prefill)")
    say(f"  launch counts: {json.dumps(counts)}")
    for b in range(B):
        say(f"  seq{b}: {tokens[b].tolist()}")
    with torch.no_grad():
        name = spec["kernel"].split("_")[0]    # flash / mlstm
        prof = {"prefill": _device_profile(
                    "prefill", lambda: prefill(params, {"tokens": prompt}),
                    name),
                "decode": _device_profile(
                    "2 decode steps", lambda: [decode(params, cache, tok)
                                               for _ in range(2)], name)}
    del cache
    if counts[spec["kernel"]] != spec["per_prefill"]:
        raise AssertionError(f"{arch}: {counts[spec['kernel']]} "
                             f"{spec['kernel']} launches, want "
                             f"{spec['per_prefill']} per prefill")
    if not (torch.isfinite(logits).all() and torch.isfinite(step_logits).all()):
        raise AssertionError(f"{arch}: non-finite logits")
    if logits.shape != (B, cfg.padded_vocab):
        raise AssertionError(f"{arch}: logits {tuple(logits.shape)}")

    holds = {"bf16": _lm_holds(cfg, params, prompt, logits, prefill_cache)}
    del prefill_cache
    if spec["f32_twin"]:
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        params32 = _cast_tree(params, torch.float32)
        with torch.no_grad():
            lg32, cache32 = M.make_prefill_step(cfg32)(params32,
                                                       {"tokens": prompt})
        holds["f32"] = _lm_holds(cfg32, params32, prompt, lg32, cache32)
        del params32, cache32
        dtype_err = _rel_l2(holds["bf16"]["plain_logits"],
                            holds["f32"]["plain_logits"])
        say(f"  the model's own bf16 error: plain bf16 vs plain f32 "
            f"prefill logits rel L2 {dtype_err:.3e}")
        failures = (_say_holds("f32", holds["f32"], LM_F32_REL_L2,
                               LM_F32_REL_L2)
                    + _say_holds("bf16", holds["bf16"], dtype_err,
                                 float("inf")))
        # (d) each layer's kernel output, on the plain route's input, lies
        # closer to the plain output than bf16 rounding puts that output
        # from its float32 twin.
        layers = _mlstm_layers(cfg, params, prompt)
        worst = max(k for k, _ in layers)
        say(f"  bf16 (d) layer by layer: kernel vs plain rel L2 "
            f"{min(k for k, _ in layers):.3e}-{worst:.3e}; plain vs f32 "
            f"{min(e for _, e in layers):.3e}-"
            f"{max(e for _, e in layers):.3e}")
        failures += [f"bf16 (d) layer {i}: kernel {k} > bf16 error {e}"
                     for i, (k, e) in enumerate(layers) if k > e]
        holds["layers"] = layers
    else:
        failures = _say_holds("bf16", holds["bf16"], LM_LOGIT_REL_L2,
                              LM_STATE_REL_L2)
    torch.cuda.synchronize()
    if failures:
        raise AssertionError(f"{arch}: " + "; ".join(failures))
    del params
    torch.cuda.empty_cache()
    for key in ("bf16", "f32"):
        holds.get(key, {}).pop("plain_logits", None)
    return counts, {"prefill_s": t_prefill, "decode_s": sum(steps),
                    "decode_step_first_s": steps[0],
                    "decode_step_median_s": statistics.median(steps),
                    "peak_gb": peak_gb, "peak_prefill_gb": peak_prefill_gb,
                    "profile": prof, "holds": holds, "n_params": n_params}


def _module_env() -> dict:
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (os.path.join(HERE, "src"), os.environ.get("PYTHONPATH"))
        if p))


def _start_module(args: list[str]):
    """``python -m <args>`` started from the checkout: (process, start)."""
    return (subprocess.Popen([sys.executable, "-m", *args], cwd=HERE,
                             env=_module_env(), stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True),
            time.perf_counter())


def _finish_module(tag: str, proc, t0: float,
                   timeout: int = 300) -> list[str]:
    """Wait for a started module; its stdout lines (echoed with ``tag``);
    fails unless it exits 0 (and kills it past ``timeout``)."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    for line in out.splitlines():
        say(f"  {tag}: {line}")
    if proc.returncode != 0:
        raise AssertionError(f"{tag} exited {proc.returncode}:\n"
                             f"{err[-4000:]}")
    say(f"  {tag} exited 0 in {time.perf_counter() - t0:.3f} s")
    return out.splitlines()


def _run_module(tag: str, args: list[str], timeout: int = 300) -> list[str]:
    """``python -m <args>`` from the checkout on the card; its stdout lines
    (echoed with ``tag``); fails unless it exits 0."""
    return _finish_module(tag, *_start_module(args), timeout=timeout)


def run_serve_cli() -> None:
    """``python -m repro_torch.launch.serve`` at full width on the card,
    and at the smoke widths of both served models (head widths 16 and 32,
    which the kernels run zero-padded to 64)."""
    _run_module("serve", ["repro_torch.launch.serve", "--arch",
                          "xlstm-350m", "--device", "cuda", "--prompt-len",
                          "8", "--gen", "4"])
    for arch in LM_PATHS:
        _run_module(f"serve --smoke {arch}",
                    ["repro_torch.launch.serve", "--arch", arch, "--smoke",
                     "--device", "cuda"])


# --------------------------------------------------------------------------
# Phase 10: the MoE, VLM, encdec and hybrid families at full width
# --------------------------------------------------------------------------
def _family_batch(cfg, B: int, P: int, gen, dev) -> dict:
    """A seeded serving batch on the card: tokens; for the VLM a vision
    prefix of ``vision_tokens`` embeddings at the embedding's scale and
    M-RoPE positions (the temporal channel ``arange(P)``, the height and
    width channels walking an 8-wide patch grid over the prefix, the
    temporal position after it); for encdec ``encoder_seq`` frames."""
    import torch
    dt = getattr(torch, cfg.dtype)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, P),
                                     generator=gen, device=dev)}
    if cfg.mrope:
        V = cfg.vision_tokens
        t = torch.arange(P, dtype=torch.int32, device=dev)
        pos = t.expand(3, B, P).clone()
        grid = torch.arange(V, dtype=torch.int32, device=dev)
        pos[1, :, :V] = grid // 8
        pos[2, :, :V] = grid % 8
        batch["positions"] = pos
        batch["vision_embeds"] = (torch.randn(
            (B, V, cfg.d_model), generator=gen, device=dev)
            * cfg.d_model ** -0.5).to(dt)
    if cfg.family == "encdec":
        batch["frames"] = torch.randn((B, cfg.encoder_seq, cfg.d_model),
                                      generator=gen, device=dev).to(dt)
    return batch


def _decode_positions(cfg, B: int, pos: int, dev):
    """M-RoPE positions of one decode step at ``pos`` (all three channels),
    None for the other families."""
    import torch
    if not cfg.mrope:
        return None
    return torch.full((3, B, 1), pos, dtype=torch.int32, device=dev)


def _family_state_errors(cache, plain) -> dict:
    """Relative L2 error of each layer's slice of every cache tensor (K, V,
    cross K / V, SSM state, conv tail), worst layer per key."""
    import torch
    return {key: max(_rel_l2(val[i], plain[key][i])
                     for i in range(val.shape[0]))
            for key, val in cache.items() if torch.is_tensor(val)}


def _spy_prefill(cfg, params, batch, attn_impl: str):
    """One prefill by ``attn_impl`` that also records, at each bf16
    attention call of the plain route, the relative L2 distances between
    the kernel's output on the same inputs, the plain one and the plain
    version's float32 twin (the layer hold (d)), and each MoE layer's
    top-k experts of every token.  Returns (logits, cache, [(kernel vs
    plain, kernel vs f32, plain vs f32)], [expert sets])."""
    import torch
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention import ref as flash_ref
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T

    plain_fn, router_fn = flash_ref.flash_attention, T._router
    layers, experts = [], []

    def attention(q, k, v, *, causal=True, window=0, scale=None):
        out = plain_fn(q, k, v, causal=causal, window=window)
        if q.dtype != torch.float32:
            exact = plain_fn(q.float(), k.float(), v.float(), causal=causal,
                             window=window)
            kernel = flash_ops.flash_attention(q, k, v, causal=causal,
                                               window=window)
            layers.append((_rel_l2(kernel, out), _rel_l2(kernel, exact),
                           _rel_l2(out, exact)))
        return out

    def router(x, w, K):
        top_w, top_i = router_fn(x, w, K)
        experts.append(torch.sort(top_i, dim=-1).values.reshape(-1, K))
        return top_w, top_i
    flash_ref.flash_attention, T._router = attention, router
    try:
        with torch.no_grad():
            logits, cache = M.make_prefill_step(cfg, attn_impl=attn_impl)(
                params, batch)
    finally:
        flash_ref.flash_attention, T._router = plain_fn, router_fn
    return logits, cache, layers, experts


def _family_holds(cfg, params, batch, logits, prefill_cache) -> dict:
    """Holds (a)-(c) of one prefill, as :func:`_lm_holds`, on a batch with
    the family's extra inputs: (a) the plain prefill, (b) a prefill of the
    first P-1 tokens (and positions) plus one decode step of the last,
    (c) top-1 agreement of both; and (d) each bf16 attention call of the
    plain prefill, fed the plain route's input, where the kernel's output
    must lie no further than BF16_ERROR_RATIO times as far from the float32
    twin as the plain one does (both round the same inputs to bf16 at
    the same places).  For MoE, the share
    of (token, layer) pairs whose top-k expert set differs between the
    kernel's prefill and the plain one (routing flips)."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T

    P = batch["tokens"].shape[1]
    short = dict(batch, tokens=batch["tokens"][:, :-1])
    last_pos = None
    if "positions" in batch:
        short["positions"] = batch["positions"][..., :-1]
        last_pos = batch["positions"][..., -1:]
    lg_plain, cache_plain, layers, experts = _spy_prefill(
        cfg, params, batch, "plain")
    states = _family_state_errors(prefill_cache, cache_plain)
    del cache_plain
    flips = None
    if cfg.num_experts:
        *_, kernel_experts = _spy_prefill(cfg, params, batch, "kernel")
        flips = float(torch.cat([(a != b).any(-1) for a, b in zip(
            experts, kernel_experts)]).float().mean())
    with torch.no_grad():
        _, cache_b = M.make_prefill_step(cfg)(params, short)
        lg_b, _ = M.make_decode_step(cfg)(params, T.grow_cache(cache_b, P),
                                          batch["tokens"][:, -1:], last_pos)
        del cache_b
    top_a, rows_a = _top1(logits, lg_plain)
    top_b, rows_b = _top1(lg_b, logits)
    return {"rel_l2_a": _rel_l2(logits, lg_plain), "states_a": states,
            "rel_l2_b": _rel_l2(lg_b, logits), "top1_a": top_a,
            "rows_a": rows_a, "top1_b": top_b, "rows_b": rows_b,
            "layers_d": layers, "routing_flips": flips,
            "plain_logits": lg_plain, "decode_logits": lg_b}


def _say_twin_hold(holds: dict, logits) -> list:
    """The bf16 model against its float32 twin: the kernel prefill's
    logits and prefill(P-1) + one decode step's, each no further from the
    float32 plain prefill's than BF16_ERROR_RATIO times the bf16 plain
    prefill's own distance; return the failures."""
    truth = holds["f32"]["plain_logits"]
    own = _rel_l2(holds["bf16"]["plain_logits"], truth)
    errs = {"kernel prefill": _rel_l2(logits, truth),
            "prefill(P-1) + decode": _rel_l2(holds["bf16"]["decode_logits"],
                                             truth)}
    holds["bf16"]["twin"] = dict(errs, plain=own)
    say(f"  bf16 against the f32 model's plain prefill, logits rel L2: "
        f"plain bf16 {own:.3e} (the model's own bf16 error); "
        + "; ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f" (hold {BF16_ERROR_RATIO} x {own:.3e})")
    return [f"bf16 {k} vs the f32 model: {v} > {BF16_ERROR_RATIO} x {own}"
            for k, v in errs.items() if v > BF16_ERROR_RATIO * own]


def _say_layer_hold(h: dict) -> list:
    """Print hold (d) and the MoE's routing flips; return the failures."""
    layers = h["layers_d"]
    say(f"  bf16 (d) layer by layer ({len(layers)} attention calls of the "
        f"plain prefill): kernel vs f32 rel L2 "
        f"{min(r[1] for r in layers):.3e}-{max(r[1] for r in layers):.3e}, "
        f"plain vs f32 {min(r[2] for r in layers):.3e}-"
        f"{max(r[2] for r in layers):.3e} (hold: kernel <= "
        f"{BF16_ERROR_RATIO} x plain, worst ratio {max(r[1] / r[2] for r in layers):.3f}); "
        f"kernel vs plain {min(r[0] for r in layers):.3e}-"
        f"{max(r[0] for r in layers):.3e}"
        + ("" if h["routing_flips"] is None else
           f"; routing flips (kernel vs plain prefill): "
           f"{h['routing_flips']:.4f} of (token, layer) pairs"))
    return [f"bf16 (d) attention call {i}: kernel vs f32 {k} > "
            f"{BF16_ERROR_RATIO} x plain vs f32 {e}"
            for i, (_, k, e) in enumerate(layers) if k > BF16_ERROR_RATIO * e]


def run_family_path(arch: str) -> tuple[dict, dict]:
    """Serve ``arch`` on the card (FAMILY_PATHS: whole, or at full width
    cut to ``layers``): seeded bf16 parameters, one prefill through
    ``make_prefill_step`` (flash attention), GEN_STEPS greedy decode steps
    from its cache grown to P + GEN_STEPS + 2; launch counts zeroed just
    before the prefill and read after the decode steps.  Then the profile
    of a prefill and two decode steps, and holds (a)-(d) (with
    ``f32_twin``, on a float32 copy too).  Frees the model's memory
    before it returns the counts and the numbers."""
    import dataclasses

    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T

    spec = FAMILY_PATHS[arch]
    cfg = get_config(arch)
    if spec["layers"]:
        cfg = dataclasses.replace(cfg, num_layers=spec["layers"])
    dev = torch.device("cuda")
    B, P = spec["batch"], spec["prompt"]
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = M.init(cfg, gen, dev)
    batch = _family_batch(cfg, B, P, gen, dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    say(f"  {arch}: {cfg.num_layers} layers (published "
        f"{get_config(arch).num_layers}), d_model {cfg.d_model}, "
        f"{cfg.num_heads} / {cfg.num_kv_heads} heads of "
        f"{cfg.resolved_head_dim}, vocab {cfg.vocab_size}, {n_params} "
        f"parameters in {cfg.dtype} ({n_params * 2 / 1e9:.3f} GB), inputs "
        f"{json.dumps({k: list(v.shape) for k, v in batch.items()})}, init "
        f"{time.perf_counter() - t0:.3f} s")
    prefill = M.make_prefill_step(cfg)
    decode = M.make_decode_step(cfg)
    torch.cuda.reset_peak_memory_stats()
    steps = []
    with torch.no_grad():
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        logits, cache = prefill(params, batch)
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        prefill_cache = cache            # decode writes only into copies
        cache = T.grow_cache(cache, P + GEN_STEPS + 2)   # + 2 profiled
        tok = logits.argmax(-1, keepdim=True)
        toks = [tok]
        for i in range(GEN_STEPS):
            t0 = time.perf_counter()
            step_logits, cache = decode(
                params, cache, tok, _decode_positions(cfg, B, P + i, dev))
            tok = step_logits.argmax(-1, keepdim=True)
            torch.cuda.synchronize()
            steps.append(time.perf_counter() - t0)
            toks.append(tok)
        counts = dict(kernels.launch_counts)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    tokens = torch.cat(toks, dim=1).cpu()
    say(f"  prefill B={B} P={P}: {t_prefill:.6f} s "
        f"({B * P / t_prefill:.1f} tok/s); {GEN_STEPS} greedy steps: "
        f"{sum(steps):.6f} s (first {steps[0] * 1e3:.3f} ms, median "
        f"{statistics.median(steps) * 1e3:.3f} ms/step); peak memory "
        f"{peak_gb:.3f} GB")
    say(f"  flash attention launches per prefill: "
        f"{counts['flash_attention']} (want {spec['per_prefill']}); all "
        f"launch counts: {json.dumps(counts)}")
    for b in range(B):
        say(f"  seq{b}: {tokens[b].tolist()}")
    if counts["flash_attention"] != spec["per_prefill"]:
        raise AssertionError(f"{arch}: {counts['flash_attention']} flash "
                             f"attention launches, want "
                             f"{spec['per_prefill']} per prefill")
    if not (torch.isfinite(logits).all()
            and torch.isfinite(step_logits).all()):
        raise AssertionError(f"{arch}: non-finite logits")
    if logits.shape != (B, cfg.padded_vocab):
        raise AssertionError(f"{arch}: logits {tuple(logits.shape)}")
    with torch.no_grad():
        pos = _decode_positions(cfg, B, P + GEN_STEPS, dev)
        prof = {"prefill": _device_profile(
                    "prefill", lambda: prefill(params, batch), "flash"),
                "decode": _device_profile(
                    "2 decode steps", lambda: [decode(params, cache, tok, pos)
                                               for _ in range(2)], "flash")}
    del cache
    holds = {"bf16": _family_holds(cfg, params, batch, logits,
                                   prefill_cache)}
    del prefill_cache
    if spec["f32_twin"]:
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        params32 = _cast_tree(params, torch.float32)
        batch32 = {k: v.float() if v.is_floating_point() else v
                   for k, v in batch.items()}
        with torch.no_grad():
            lg32, cache32 = M.make_prefill_step(cfg32)(params32, batch32)
        holds["f32"] = _family_holds(cfg32, params32, batch32, lg32, cache32)
        del params32, cache32, batch32
        failures = (_say_holds("f32", holds["f32"], LM_F32_REL_L2,
                               LM_F32_REL_L2)
                    + _say_holds("bf16", holds["bf16"], float("inf"),
                                 float("inf"))
                    + _say_twin_hold(holds, logits))
    else:
        # MoE: bf16 rounding flips some tokens' top-k experts between the
        # two prefills, and a flipped token's later K/V move with it, so
        # the K/V hold is printed and the layer hold (d) stands in for it.
        failures = _say_holds("bf16", holds["bf16"], LM_LOGIT_REL_L2,
                              float("inf") if cfg.num_experts
                              else LM_STATE_REL_L2)
    failures += _say_layer_hold(holds["bf16"])
    for key in holds:
        holds[key].pop("plain_logits")
        holds[key].pop("decode_logits")
    del params, batch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"{arch}: " + "; ".join(failures))
    return counts, {"layers": cfg.num_layers, "batch": B, "prompt": P,
                    "prefill_s": t_prefill, "decode_s": sum(steps),
                    "decode_step_first_s": steps[0],
                    "decode_step_median_s": statistics.median(steps),
                    "peak_gb": peak_gb, "profile": prof, "holds": holds,
                    "n_params": n_params}


def _leaves(tree: dict) -> list:
    return [leaf for v in tree.values()
            for leaf in (_leaves(v) if isinstance(v, dict) else [v])]


def run_family_serve_cli() -> None:
    """``serve --smoke --device cuda`` for one configuration of each of
    phase 10's families, the four subprocesses at once; each must exit
    0."""
    procs = {arch: _start_module(["repro_torch.launch.serve", "--arch", arch,
                                  "--smoke", "--device", "cuda"])
             for arch in FAMILY_SERVE_SMOKE}
    for arch, (proc, t0) in procs.items():
        _finish_module(f"serve --smoke {arch}", proc, t0)


# --------------------------------------------------------------------------
# Phase 8: LM training
# --------------------------------------------------------------------------
def run_train_cli() -> list[float]:
    """The training entry point at full width, twice over one checkpoint
    directory: the second invocation must resume from the first's last
    step.  Returns the losses both printed."""
    import math
    import shutil
    import tempfile
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_train_")
    base = ["repro_torch.launch.train", "--arch", TRAIN["arch"], "--batch",
            str(TRAIN["batch"]), "--seq", str(TRAIN["seq"]), "--ckpt-dir",
            ckpt, "--log-every", "1", "--device", "cuda"]
    first, last = TRAIN["steps"]
    try:
        out = _run_module("train", base + ["--steps", str(first)], 900)
        out2 = _run_module("train (resume)", base + ["--steps", str(last)],
                           900)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    if f"resumed from step {first}" not in out2 or out2[-1] != "done":
        raise AssertionError("the second training run did not resume from "
                             f"step {first}")
    losses = [float(line.split()[3]) for line in out + out2
              if line.startswith("step ")]
    if len(losses) != last or not all(map(math.isfinite, losses)):
        raise AssertionError(f"training losses: {losses}")
    return losses


def run_train_path() -> dict:
    """xlstm-350m's train step at full width in process: one warm-up
    step, TRAIN_TIMED timed steps, two under the profiler; s/step,
    tokens/s, peak memory, idle share, and the model-FLOP rate (6 N
    tokens a step, an estimate) against the bf16 peak.  No kernel runs
    on the training path (its loss is the reference's XLA-twin code), and
    the counts, zeroed before and read after, must say so."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch import train
    from repro_torch.models import model as M
    from repro_torch.tree import tree_leaves

    tc = TrainConfig(learning_rate=1e-3, warmup_steps=10, total_steps=100,
                     remat_policy="none")
    cfg, opt = train.build(TRAIN["arch"], False, tc)
    dev = torch.device("cuda")
    step = M.make_train_step(cfg, opt, tc)
    state = M.init_train_state(cfg, opt,
                               torch.Generator(device=dev).manual_seed(0),
                               dev)
    n = sum(t.numel() for t in tree_leaves(state.params))
    batches = train.make_batch_fn(cfg, TRAIN["batch"], TRAIN["seq"])
    tokens = TRAIN["batch"] * TRAIN["seq"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    state, m = step(state, batches(0))
    torch.cuda.synchronize()
    times = []
    for s in range(1, 1 + TRAIN_TIMED):
        b = batches(s)
        t0 = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    # the steps' own peak: the profiled steps below hold one more state
    peak_steps_gb = torch.cuda.max_memory_allocated() / 1e9
    bs = [batches(s) for s in range(1 + TRAIN_TIMED, 3 + TRAIN_TIMED)]
    holder = {"state": state}

    def two_steps():
        for b in bs:
            holder["state"], holder["m"] = step(holder["state"], b)
    prof = _device_profile("2 train steps", two_steps, "mlstm")
    counts = dict(kernels.launch_counts)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    s_step = statistics.median(times)
    flops = 6 * n * tokens
    loss = float(holder["m"]["loss"])
    say(f"  {TRAIN['arch']}: {n} parameters ({cfg.dtype}), AdamW f32 "
        f"moments, batch {TRAIN['batch']} x {TRAIN['seq']} tokens: "
        f"{s_step:.6f} s/step (median of {TRAIN_TIMED}: "
        f"{', '.join(f'{t:.6f}' for t in times)}), {tokens / s_step:.1f} "
        f"tokens/s, peak memory {peak_gb:.3f} GB ({peak_steps_gb:.3f} GB "
        f"over the unprofiled steps), idle share "
        f"{prof['idle_share']:.4f} over 2 profiled steps, model FLOPs "
        f"6 N tokens = {flops:.4e} a step, {flops / s_step / 1e12:.3f} "
        f"TFLOP/s = {flops / s_step / PEAK_BF16_FLOPS:.5f} of 989 TFLOP/s "
        f"(an estimate), loss {loss:.4f}")
    say(f"  launch counts: {json.dumps(counts)}")
    if any(counts.values()):
        raise AssertionError(f"a kernel launched on the training path: "
                             f"{counts}")
    if not (loss == loss and abs(loss) < float("inf")):
        raise AssertionError(f"training loss {loss}")
    del state, holder
    torch.cuda.empty_cache()
    return {"s_per_step": s_step, "steps_s": times,
            "tokens_per_s": tokens / s_step, "peak_gb": peak_gb,
            "peak_steps_gb": peak_steps_gb,
            "idle_share": prof["idle_share"], "n_params": n,
            "mfu_estimate": flops / s_step / PEAK_BF16_FLOPS,
            "profile": prof}


def hold_train_step_cpu() -> dict:
    """One train step on the card against the same step on the CPU, f32 at
    smoke size, for both trained families (TRAIN_HOLD: the floor,
    widened to twice the model's own one-ulp conditioning where that is
    larger, up to the ceiling)."""
    import numpy as np
    import torch
    from repro_torch import optim
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.data import TokenPipeline
    from repro_torch.models import model as M
    from repro_torch.tree import tree_leaves, tree_map

    lr, cpu = 1e-3, torch.device("cpu")

    def run(step, opt, params, dev):
        """(loss, grad norm, the update as one float64 vector)."""
        p = tree_map(lambda t: t.to(dev), params)
        st, m = step(optim.TrainState(
            torch.zeros((), dtype=torch.int32, device=dev), p, opt.init(p)),
            batch)
        return (float(m["loss"]), float(m["grad_norm"]), np.concatenate(
            [(t.double().cpu() - o.double()).numpy().ravel()
             for t, o in zip(tree_leaves(st.params), tree_leaves(params))]))

    def distance(a, b, name):
        """loss, grad norm and update distances of two runs."""
        upd = (float(np.linalg.norm(a[2] - b[2]) / np.linalg.norm(b[2]))
               if name == "sgd" else float((np.abs(a[2] - b[2]) > 1e-6).mean()))
        return {"loss": abs(a[0] - b[0]) / abs(b[0]),
                "grad_norm": abs(a[1] - b[1]) / abs(b[1]), name if name ==
                "sgd" else "adam_share": upd}

    out = {}
    for arch, floor in TRAIN_HOLD.items():
        cfg = smoke_variant(get_config(arch))
        params = M.init(cfg, torch.Generator().manual_seed(0), cpu)
        batch = TokenPipeline(cfg.vocab_size, 64, 4, seed=1).batch(0)
        res = {}
        for name in ("adamw", "sgd"):
            opt = optim.make_optimizer(name, optim.constant(lr))
            step = M.make_train_step(cfg, opt)
            on_cpu = run(step, opt, params, cpu)
            on_card = run(step, opt, params, torch.device("cuda"))
            got = distance(on_card, on_cpu, name)
            sens = {k: 0.0 for k in got}
            for seed in (1, 2):
                gen = torch.Generator().manual_seed(seed)
                noisy = tree_map(lambda t: t * (1 + torch.randn(
                    t.shape, generator=gen) * 2.0 ** -24), params)
                d = distance(run(step, opt, noisy, cpu), on_cpu, name)
                sens = {k: max(sens[k], d[k]) for k in got}
            hold = {k: min(floor[k][1], max(floor[k][0], 2 * sens[k]))
                    for k in got}
            say(f"  {arch} smoke f32 {name} step, card vs CPU: loss "
                f"{on_card[0]:.6f} / {on_cpu[0]:.6f}; " + ", ".join(
                    f"{k} {got[k]:.3e} (hold {hold[k]:.3e}; one-ulp "
                    f"noise on the CPU {sens[k]:.3e})" for k in got))
            bad = [k for k in got if got[k] > hold[k]]
            if name == "adamw":
                worst = float(np.abs(on_card[2] - on_cpu[2]).max())
                say(f"    AdamW update max |diff| {worst:.3e} (hold 2 lr)")
                if worst > 2 * lr * (1 + 1e-3):
                    bad.append("adamw max |diff|")
            if bad:
                raise AssertionError(f"{arch} {name} step: card and CPU "
                                     f"disagree on {bad}")
            res[name] = {"card_vs_cpu": got, "one_ulp": sens, "hold": hold}
        out[arch] = res
    return out


# --------------------------------------------------------------------------
# Phase 9: federated LM training over MUDP
# --------------------------------------------------------------------------
def run_lm_fl_path() -> tuple[dict, dict, dict]:
    """fl_train_lm --scale 100m over WAN links on the card, LMFL_ROUNDS
    rounds with checkpoints and the journal; launch counts zeroed just
    before and read just after; the fedavg / quantize / dequantize calls
    by shape.  Then the tiny scale on the card and on the CPU: identical
    round records, NLL within NLL_TOL; after one round of one local step,
    the global model's moves within PARAM_TOL, and a CPU run with no-op
    local steps outside it."""
    import collections
    import math
    import shutil
    import tempfile

    from repro_torch import fl_train_lm, kernels
    from repro_torch.kernels.fedavg import ops as fedavg_ops
    from repro_torch.kernels.quantize import ops as quant_ops

    by_shape = {n: collections.Counter()
                for n in ("fedavg", "quantize", "dequantize")}
    orig = (quant_ops.quantize, quant_ops.dequantize, fedavg_ops.fedavg)

    def shaped(name, fn, tensor_arg, n_arg=None):
        """``fn`` counting its calls by (rows x width) of its input (for
        dequantize, rows x the n values it expands)."""
        def call(*a, **kw):
            rows, width = a[tensor_arg].shape
            if n_arg is not None:
                width = a[n_arg]
            by_shape[name][f"{rows}x{width}"] += 1
            return fn(*a, **kw)
        return call
    quant_ops.quantize = shaped("quantize", orig[0], 0)
    quant_ops.dequantize = shaped("dequantize", orig[1], 0, n_arg=2)
    fedavg_ops.fedavg = shaped("fedavg", orig[2], 0)
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_fl_")
    try:
        args = fl_train_lm.parser().parse_args(
            ["--scale", "100m", "--clients", "3", "--rounds",
             str(LMFL_ROUNDS), "--device", "cuda", "--ckpt-dir", ckpt])
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        records = fl_train_lm.run(args)
        wall = time.perf_counter() - t0
        counts = dict(kernels.launch_counts)
    finally:
        quant_ops.quantize, quant_ops.dequantize, fedavg_ops.fedavg = orig
        shutil.rmtree(ckpt, ignore_errors=True)
    for rec in records:
        say(f"  round {rec['round']}: wall {rec['wall_s']:.6f} s, local "
            f"steps {rec['train_s']:.6f} s, int8 encode/decode "
            f"{rec['wire_s']:.6f} s, checkpoint save {rec['ckpt_s']:.6f} s, "
            f"arrived {len(rec['arrived'])}/3, eval NLL {rec['nll']:.6f}")
    by_shape = {n: dict(c.most_common()) for n, c in by_shape.items()}
    say(f"  launch counts: {json.dumps(counts)}; calls by shape: "
        f"{json.dumps(by_shape)}; {wall:.3f} s in all")
    for name in ("fedavg", "quantize", "dequantize"):
        if counts.get(name, 0) <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"LM-FL path")
    if any(len(r["arrived"]) < 2 for r in records):
        raise AssertionError("a round aggregated fewer than 2 of 3 clients")
    last = records[-1]
    if not (math.isfinite(last["nll"]) and last["nll"] < last["first_nll"]):
        raise AssertionError(f"eval NLL {last['nll']} after the last round, "
                             f"{last['first_nll']} before the first")
    if last["resume_round"] != LMFL_ROUNDS:
        raise AssertionError(f"resume round {last['resume_round']}")

    return counts, by_shape, {"records": records, "wall_s": wall,
                              **hold_lm_fl_tiny("cuda")}


def hold_lm_fl_tiny(dev: str = "cuda") -> dict:
    """``fl_train_lm --scale tiny`` on ``dev`` against the CPU from one
    set of weights: identical round records and NLL within NLL_TOL after
    two rounds of two local steps; after one round of one local step, the
    global model's moves within PARAM_TOL of each other, and a CPU run
    whose local steps are no-ops outside it."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from repro_torch import fl_train_lm
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.models import model as M
    from repro_torch.tree import tree_leaves

    # Both runs start from one set of weights, drawn on the CPU (a
    # generator on the card draws other numbers).
    start = M.init(fl_train_lm.model_config("tiny"),
                   torch.Generator().manual_seed(0), "cpu")
    tiny = {}
    for where in (dev, "cpu"):
        d = tempfile.mkdtemp(prefix="chip_smoke_fl_tiny_")
        try:
            tiny[where] = fl_train_lm.run(fl_train_lm.parser().parse_args(
                LMFL_TINY + ["--device", where, "--ckpt-dir", d]), start)
        finally:
            shutil.rmtree(d, ignore_errors=True)
    keys = ("t_ns", "arrived", "retx", "wire_bytes")
    same = ([{k: r[k] for k in keys} for r in tiny[dev]]
            == [{k: r[k] for k in keys} for r in tiny["cpu"]])
    dn = max(abs(a["nll"] - b["nll"]) for a, b in zip(tiny[dev],
                                                       tiny["cpu"]))
    d0 = abs(tiny[dev][-1]["first_nll"] - tiny["cpu"][-1]["first_nll"])
    say(f"  tiny on the card and the CPU from the same weights: round "
        f"records identical {same}; eval NLL before the first round "
        f"|diff| {d0:.3e}, after each round max |diff| {dn:.6f} (hold "
        f"{NLL_TOL})")
    if not same or dn > NLL_TOL or d0 > 1e-4:
        raise AssertionError("tiny LM-FL: card and CPU disagree")

    def flat(tree):
        return np.concatenate([t.double().cpu().numpy().ravel()
                               for t in tree_leaves(tree)])

    def one_round_move(where, make_step=M.make_train_step):
        """The global model's move over one round of one local step, from
        the last checkpoint, as one float64 vector."""
        d = tempfile.mkdtemp(prefix="chip_smoke_fl_move_")
        saved, M.make_train_step = M.make_train_step, make_step
        try:
            fl_train_lm.run(fl_train_lm.parser().parse_args(
                LMFL_ONE_STEP + ["--device", where, "--ckpt-dir", d]), start)
            tree, _ = CheckpointManager(d).restore(start)
        finally:
            M.make_train_step = saved
            shutil.rmtree(d, ignore_errors=True)
        return flat(tree) - flat(start)

    def no_op_step(cfg, opt):
        return lambda state, batch: (state, {"loss": torch.zeros(())})
    want = one_round_move("cpu")
    moved = {"card": one_round_move(dev),
             "no-op": one_round_move("cpu", no_op_step)}
    dist = {k: float(np.linalg.norm(v - want) / np.linalg.norm(want))
            for k, v in moved.items()}
    say(f"  tiny, one round of one local step from the same weights: the "
        f"global model's move on the card lies {dist['card']:.6f} (relative "
        f"L2) from the CPU's (hold {PARAM_TOL}); a run with no-op local "
        f"steps lies {dist['no-op']:.6f} from it (must exceed the hold)")
    if not dist["card"] <= PARAM_TOL < dist["no-op"]:
        raise AssertionError("tiny LM-FL: the card's model moved unlike "
                             "the CPU's, or the hold passes a no-op run")
    return {"tiny_nll_diff": dn, "tiny_first_nll_diff": d0,
            "tiny_move_rel_l2": dist}


# --------------------------------------------------------------------------
# Phase 11: the rest of the fleet layer (hier, gossip, async, vmap)
# --------------------------------------------------------------------------
#: The five FL kernels on the adaptive paths, by the wrapper module that
#: launches each.
FL_WRAPPERS = (("fedavg", "fedavg"), ("quantize", "quantize"),
               ("quantize", "dequantize"), ("topk", "topk_gather"),
               ("topk", "topk_scatter"))
#: the extra rounds (sync) or aggregations (async) profiled per arm
PROFILED_ROUNDS = {"sync": 3, "async": 6}
MATRIX_CLIENTS = (16, 64, 256)
MATRIX_BUDGET_S = 0.4
#: (c)'s hold on the global parameters, vmap against python: the port's
#: MLP-against-reference tolerance (``tests/test_torch_fleet.py``).  On
#: the card the per-client path's single matrix products and the vmap
#: path's batched ones reduce in different orders (cuBLAS picks the
#: kernels), so the CPU tests' 4-ULP hold cannot apply; the ULP distances
#: are printed beside it.
VMAP_ATOL = 1e-4


def _shape_key(name: str, args) -> str:
    if name == "topk_gather":
        x, idx = args[:2]
        return f"{x.shape[0]}x{x.shape[1]}->{idx.shape[1]}"
    if name == "topk_scatter":
        idx, _, n = args[:3]
        return f"{idx.shape[0]}x{n}->{idx.shape[1]}"
    if name == "dequantize":
        return f"{args[1].shape[0]}x{args[2]}"
    return "x".join(str(d) for d in args[0].shape)


def _calls_by_shape(wrappers=None):
    """Wrap the kernels' wrappers (default: the five FL kernels') so each
    call is counted by its shape; returns ``(counters, undo)``."""
    import collections
    import importlib
    wrappers = FL_WRAPPERS if wrappers is None else wrappers
    counters = {name: collections.Counter() for _, name in wrappers}
    saved = []
    for family, name in wrappers:
        mod = importlib.import_module(f"repro_torch.kernels.{family}.ops")
        fn = getattr(mod, name)

        def counted(*args, _fn=fn, _name=name, **kwargs):
            counters[_name][_shape_key(_name, args)] += 1
            return _fn(*args, **kwargs)
        saved.append((mod, name, fn))
        setattr(mod, name, counted)

    def undo():
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return counters, undo


def _profile_call(fn) -> dict:
    """Wall time, device busy time and idle share of one ``fn()`` under
    ``torch.profiler`` (device activity only)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    busy_s = sum(e.self_device_time_total for e in rows) / 1e6
    return {"wall_s": wall, "device_busy_s": busy_s,
            "idle_share": 1 - busy_s / wall,
            "device_ops": sum(e.count for e in rows)}


def _run_arm(label: str, transport: str, shapes: bool = False,
             **arm) -> tuple[dict, dict, list[dict]]:
    """One arm of ``fleet_sim`` on the card at full width: its horizon's
    rounds with the launch counts zeroed just before and read just after
    (and with ``shapes``, the five FL kernels' calls counted by shape),
    then up to PROFILED_ROUNDS more rounds under the profiler.  Returns
    the arm's record, what the pinned rounds left (``params``: the flat
    global parameters; ``history``; ``batch_sizes``) and their per-round
    records."""
    from repro_torch import fleet_sim, kernels
    from repro_torch.core.packetizer import flatten_to_vector
    mode = arm.get("mode", "sync")
    rounds = fleet_sim.rounds_for(mode)
    build = fleet_sim.build(transport, device="cuda", **arm)
    counters, undo = _calls_by_shape() if shapes else (None, None)
    try:
        kernels.reset_launch_counts()
        records = fleet_sim.run_rounds(build, rounds)
        launches = {k: v for k, v in kernels.launch_counts.items() if v}
    finally:
        if undo is not None:
            undo()
    left = {"params": flatten_to_vector(build.system.global_params),
            "history": list(build.system.history),
            "batch_sizes": (list(build.trainer.batch_sizes)
                            if build.trainer is not None else None)}
    walls = [r["wall_s"] for r in records[1:]]
    extra = min(rounds, PROFILED_ROUNDS[mode])
    prof = dict(_profile_call(lambda: build.system.run_rounds(extra)),
                rounds=extra)
    rec = {"rounds": rounds, "wall_s_median": statistics.median(walls),
           "wall_s_first": walls[0], "wall_s": walls, "launches": launches,
           "profile": prof, "loss": records[-1]["loss"]}
    if counters is not None:
        rec["calls_by_shape"] = {name: dict(c.most_common())
                                 for name, c in counters.items()}
    acc = (f", accuracy {records[-1]['accuracy']:.4f}"
           if "accuracy" in records[-1] else "")
    say(f"  {label}: {rounds} rounds, round wall median "
        f"{rec['wall_s_median']:.6f} s (first {walls[0]:.6f}), loss "
        f"{records[-1]['loss']:.6f}{acc}; launches {json.dumps(launches)}; "
        f"profiled {prof['rounds']} more: wall {prof['wall_s']:.6f} s, "
        f"device busy {prof['device_busy_s'] * 1e3:.3f} ms, idle share "
        f"{prof['idle_share']:.4f} ({prof['device_ops']} device ops)")
    return rec, left, records


def _check_pin(label: str, view: dict, pin: dict) -> None:
    want = {"hops": pin["hops"], "rounds": pin["rounds"]}
    if view != want:
        for r, (got, exp) in enumerate(zip(view["rounds"], want["rounds"])):
            if got != exp:
                raise AssertionError(f"{label} round {r}: {got} != pinned "
                                     f"{exp}")
        raise AssertionError(f"{label}: {view} != pinned {want}")


def run_fleet_layer() -> dict:
    """Phase 11: (a) the reference example's consensus arms bitwise against
    their pins, (b) the MLP's adaptive hier arm against its pins through
    the five FL kernels, (c) the vmap backend against the python one on
    the MLP's star arm, (d) the vmap compute matrix and the learning
    curve, (e) the topology and async gates; (f) each arm's round wall,
    idle share and launches (printed with it)."""
    import hashlib

    import numpy as np
    from repro_torch import fleet_gates, fleet_sim
    from repro_torch.core.client_compute import make_model, make_train_backend

    out = {"arms": {}}
    t0 = time.perf_counter()
    say("  (a) consensus arms (1024 parameters, static control), bitwise "
        "against the reference's pins")
    for (topology, mode, transport), pin in fleet_sim.PINNED_ARMS.items():
        label = f"{transport}/{mode}/{topology}/consensus"
        rec, left, records = _run_arm(
            label, transport, model="consensus", control="static",
            topology=topology, mode=mode)
        _check_pin(label, fleet_sim.pinned_view(records), pin)
        sha = hashlib.sha256(left["params"].tobytes()).hexdigest()
        if sha != pin["sha256"]:
            raise AssertionError(f"{label}: parameters {sha} != pinned "
                                 f"{pin['sha256']}")
        say(f"    pins hold: {len(pin['rounds'])} rounds of arrivals, late "
            f"folds, retransmissions and hop bytes; sha256 {sha[:16]}")
        out["arms"][label] = rec
    out["consensus_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    say("  (b) the MLP's adaptive hier arm (mudp+fec, per-hop "
        "delta|ef|topk(0.15)|int8(1024) up, int8(1024) down, 4 cells)")
    rec, left, records = _run_arm(
        "mudp+fec/sync/hier/mlp", "mudp+fec", shapes=True, model="mlp",
        control="adaptive", topology="hier", mode="sync")
    for r in records[1:]:
        say(f"    round {r['round']}: arrived {r['arrived']}, late "
            f"{r['late_folded']}, retx {r['retransmissions']}, tiers "
            f"{json.dumps(r['tiers'])}, hop bytes "
            f"{json.dumps(r['hop_bytes'])}, accuracy {r['accuracy']:.4f}")
    _check_pin("hier adaptive", fleet_sim.pinned_view(records),
               fleet_sim.PINNED_HIER_ADAPTIVE)
    for name, by_shape in rec["calls_by_shape"].items():
        say(f"    {name}: {rec['launches'].get(name, 0)} launches; calls by "
            f"shape {json.dumps(by_shape)}")
    missing = [name for _, name in FL_WRAPPERS
               if rec["launches"].get(name, 0) <= 0]
    if missing:
        raise AssertionError(f"hier adaptive arm: {missing} never launched")
    out["arms"]["mudp+fec/sync/hier/mlp"] = rec
    out["hier_adaptive_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    say("  (c) --train-backend vmap against python: the MLP's star sync "
        "arm over mudp, 48 clients")
    runs = {}
    for backend in ("python", "vmap"):
        runs[backend] = _run_arm(
            f"mudp/sync/star/mlp[{backend}]", "mudp", model="mlp",
            control="static", topology="star", mode="sync",
            train_backend=backend)
        out["arms"][f"mudp/sync/star/mlp[{backend}]"] = runs[backend][0]
    lp, lv = runs["python"][1], runs["vmap"][1]
    n = fleet_sim.ROUNDS
    for field in ("roster", "arrived", "duration_ns"):
        if ([getattr(r, field) for r in lp["history"]]
                != [getattr(r, field) for r in lv["history"]]):
            raise AssertionError(f"vmap vs python: {field} differs")
    a, v, sizes = lp["params"], lv["params"], lv["batch_sizes"]
    diff = np.abs(a - v)
    ulp = diff / np.spacing(np.maximum(np.abs(a), np.abs(v)))
    norm_ulp = float(diff.max() / np.spacing(np.abs(a).max()))
    say(f"    rosters, arrivals and duration_ns identical over {n} rounds; "
        f"global parameters: max |python - vmap| {diff.max():.3e} "
        f"(hold {VMAP_ATOL}), elementwise max {ulp.max():.1f} ULP "
        f"(median {float(np.median(ulp)):.1f}), {norm_ulp:.1f} ULP of the "
        f"largest parameter")
    if not diff.max() <= VMAP_ATOL:
        raise AssertionError(f"vmap vs python: max diff {diff.max()} > "
                             f"{VMAP_ATOL}")
    say(f"    BatchTrainer.batch_sizes {sizes}: {sum(sizes)} trainings in "
        f"{len(sizes)} calls")
    if not len(sizes) < sum(sizes):
        raise AssertionError("the vmap backend did not batch")
    out["vmap_vs_python"] = {"max_abs": float(diff.max()),
                             "max_ulp": float(ulp.max()),
                             "norm_ulp": norm_ulp, "batch_sizes": sizes}
    out["vmap_vs_python_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    say(f"  (d) compute matrix ({fleet_gates.MATRIX_MODEL_ARGS}) at "
        f"{MATRIX_CLIENTS} clients, and the full-width MLP at 256")
    matrix = fleet_gates.compute_matrix(MATRIX_CLIENTS,
                                        budget_s=MATRIX_BUDGET_S,
                                        device="cuda")
    matrix += [dict(r, full_width=True) for r in fleet_gates.compute_matrix(
        (256,), budget_s=MATRIX_BUDGET_S, device="cuda",
        model_args=fleet_gates.CURVE_MODEL_ARGS)]
    for r in matrix:
        say(f"    {r['clients']:4d} clients, {r['n_params']} params, "
            f"{r['backend']:6s}: {r['ms_per_call']:.3f} ms a call "
            f"({r['reps']} reps), speedup {r['speedup_vs_python']:.2f}x "
            f"(the reference benchmark's gate: {fleet_gates.MIN_SPEEDUP}x, "
            f"printed, not held)")
    for args, tag in ((fleet_gates.MATRIX_MODEL_ARGS, "matrix"),
                      (fleet_gates.CURVE_MODEL_ARGS, "full width")):
        model = make_model("mlp", 256, seed=0, device="cuda", **args)
        stack, ci, ri = fleet_gates.matrix_inputs(model, 256)
        backend = make_train_backend("vmap")
        backend.train(model, stack, ci, ri)
        prof = _profile_call(lambda: backend.train(model, stack, ci, ri))
        say(f"    one profiled vmap call at 256 clients ({tag}): wall "
            f"{prof['wall_s'] * 1e3:.3f} ms, device busy "
            f"{prof['device_busy_s'] * 1e3:.3f} ms, idle share "
            f"{prof['idle_share']:.4f} ({prof['device_ops']} device ops)")
        out.setdefault("vmap_call_profile", {})[tag] = prof
    curve = fleet_gates.learning_curve(device="cuda")
    hit = fleet_gates.rounds_to_accuracy(curve["curve"],
                                         fleet_gates.TARGET_ACC)
    say(f"    learning curve (16 clients, mudp, 10% loss, non-IID alpha "
        f"0.5, vmap, {curve['data_source']} data): accuracy by round "
        f"{[round(r['accuracy'], 4) for r in curve['curve']]}; "
        f"{fleet_gates.TARGET_ACC} reached at round {hit}; batch sizes "
        f"{curve['batch_sizes'][:6]}...")
    if hit is None:
        raise AssertionError(f"learning curve: {fleet_gates.TARGET_ACC} "
                             f"not reached in 20 rounds")
    out["matrix"] = matrix
    out["curve"] = {"rounds_to_target": hit,
                    "accuracy": [r["accuracy"] for r in curve["curve"]],
                    "wall_s": curve["wall_s"]}
    out["matrix_and_curve_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    say("  (e) the topology and async gates")
    topo, fail = fleet_gates.topology_gate()
    for key, cell in topo.items():
        say(f"    topology/{key}: final loss {cell['final_loss']:.6f}, hop "
            f"bytes {json.dumps(cell['hop_bytes'])}, server nodes "
            f"{cell['server_nodes']}")
    report, fail_async = fleet_gates.async_gate()
    say(f"    async/sync time to 5% of L0: "
        f"{report['time_ratio_async_over_sync']:.4f} (gate <= 0.8); sync "
        f"{report['sync']['sim_ns_to_target']} ns, async "
        f"{report['async']['sim_ns_to_target']} ns")
    if fail or fail_async:
        raise AssertionError(f"gates failed: {fail + fail_async}")
    out["async_ratio"] = report["time_ratio_async_over_sync"]
    out["gates_s"] = time.perf_counter() - t0
    if not (np.isfinite(a).all() and np.isfinite(v).all()):
        raise AssertionError("non-finite global parameters")
    return out


# --------------------------------------------------------------------------
# Phase 12: the flow engine at fleet scale
# --------------------------------------------------------------------------
#: (a) the small flow runs pinned from the reference (every transport under
#: star, hier and gossip; one async run), (b) the deployment the
#: reference's ``benchmarks/fleet_scale.py`` names, at 10,000 clients for 2
#: rounds and 100,000 for 1, with one profiled round of the first.
FLOW_SMALL = ("flow/star", "flow/hier", "flow/gossip", "flow/async")
FLOW_SCALE = ("flow/hier32/10000", "flow/hier32/100000")
FLOW_GATE_CLIENTS, FLOW_GATE_MIN = 1024, 2.0     # the reference's floor
FLOW_OUT = os.path.join(HERE, "build", "fleet_scale")
FLOW_DEVICE = "cuda"


def _capture_calls(names):
    """Wrap the named FL wrappers (of FL_WRAPPERS) so each call keeps its
    arguments and output as ``(*args, out)`` (the wire plane and
    ``fedavg_stack`` copy their inputs to the card fresh for each call, so
    no copy is needed); returns ``(calls by name, undo)``."""
    import importlib
    family = {name: fam for fam, name in FL_WRAPPERS}
    calls, saved = {name: [] for name in names}, []
    for name in names:
        mod = importlib.import_module(
            f"repro_torch.kernels.{family[name]}.ops")
        fn = getattr(mod, name)

        def kept(*args, _fn=fn, _name=name):
            out = _fn(*args)
            calls[_name].append((*args, out))
            return out
        saved.append((mod, name, fn))
        setattr(mod, name, kept)

    def undo():
        for mod, name, fn in reversed(saved):
            setattr(mod, name, fn)
    return calls, undo


def _fleet_scale_run(label: str) -> tuple[dict, float]:
    """``python -m repro_torch.fleet_scale`` with a pinned run's arguments
    on the card, in process; the report must equal its pin."""
    from repro_torch import fleet_scale
    os.makedirs(FLOW_OUT, exist_ok=True)
    out = os.path.join(FLOW_OUT, label.replace("/", "_") + ".json")
    t0 = time.perf_counter()
    rc = fleet_scale.main([*fleet_scale.PINNED_ARGV[label], "--device",
                           FLOW_DEVICE, "--out", out])
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"fleet_scale {label}: exit code {rc}")
    with open(out) as f:
        report = json.load(f)
    pin = fleet_scale.PINS[label]
    sha, summ = fleet_scale.digest(report), fleet_scale.summary(report)
    if sha != pin["sha256"] or summ != pin["summary"]:
        raise AssertionError(f"fleet_scale {label}: {sha} {summ} != pinned "
                             f"{pin}")
    return report, wall


def _hold_fedavg_calls(label: str, calls) -> dict:
    """Each fedavg call of a run, bitwise: its output against the plain
    version and the numpy fold of the same stack; returns the calls'
    (K, N) shapes with their counts."""
    import collections

    import numpy as np
    import torch
    from repro_torch.kernels.fedavg import ref as fedavg_ref
    shapes = collections.Counter()
    for stack, w, out in calls:
        plain = fedavg_ref.fedavg(stack, w)
        acc = np.zeros(stack.shape[1], np.float32)
        for wi, row in zip(w.cpu().numpy(), stack.cpu().numpy()):
            acc += wi * row
        if not (bits_equal(out, plain)
                and bits_equal(out.cpu(), torch.from_numpy(acc))):
            raise AssertionError(f"{label}: fedavg {tuple(stack.shape)} "
                                 f"kernel != plain version / numpy fold")
        shapes[f"{stack.shape[0]}x{stack.shape[1]}"] += 1
    return dict(sorted(shapes.items(),
                       key=lambda kv: -int(kv[0].split("x")[0])))


def _time_fedavg(stack, w) -> dict:
    """fedavg at one of the flow path's stacks: its route, the kernel per
    call and on the device (20 launches in one CUDA graph), its plain
    version and ``w @ stack`` on the device, and the bound (bytes / 3.35
    TB/s)."""
    from repro_torch.kernels.fedavg import ops as fedavg_ops
    from repro_torch.kernels.fedavg import ref as fedavg_ref
    k, n = stack.shape
    nbytes = 4 * k * n + 4 * k + 4 * n
    bnd, by = bound_ms(nbytes, 2 * k * n)
    rec = {"shape": [k, n], "bytes": nbytes, "bound_ms": bnd,
           "bound_by": by,
           "route": _fedavg_plan(stack, w)._asdict(),
           "ms": time_ms(lambda: fedavg_ops.fedavg(stack, w)),
           "device_ms": device_ms(lambda: fedavg_ops.fedavg(stack, w)),
           "plain_device_ms": device_ms(
               lambda: fedavg_ref.fedavg(stack, w), calls=2),
           "library_device_ms": device_ms(lambda: w @ stack)}
    rec["share_of_bound"] = bnd / rec["device_ms"]
    say(f"    fedavg {k}x{n} ({_say_plan(stack, w)}): device "
        f"{rec['device_ms']:.6f} ms (per call {rec['ms']:.6f}), bound "
        f"{bnd:.6f} ms ({by}, {rec['share_of_bound']:.4f} of it); plain "
        f"version {rec['plain_device_ms']:.6f} ms; w @ stack "
        f"{rec['library_device_ms']:.6f} ms (kernel "
        f"{rec['device_ms'] / rec['library_device_ms']:.2f}x its time)")
    return rec


def run_flow_fleet() -> dict:
    """Phase 12: (a) the small flow runs of ``repro_torch.fleet_scale``
    against the reference's pins; (b) 10,000 clients for 2 rounds and
    100,000 for 1 under ``--engine flow --topology hier --cells 32
    --transports mudp`` against their pins, with fedavg's launches and
    calls by shape, every call held bitwise, and one profiled round at
    10,000 clients; (c) the flow gate at 1,024 clients; (d) fedavg timed
    at the (K, 2048) stacks (b) launched, beside its bound and ``w @
    stack``."""
    from repro_torch import fleet_scale, kernels
    out: dict = {"pins": {}, "scale": {}}
    t0 = time.perf_counter()
    say("  (a) small flow runs against the reference's pins")
    for label in FLOW_SMALL:
        report, wall = _fleet_scale_run(label)
        out["pins"][label] = {"wall_s": wall,
                              "summary": fleet_scale.summary(report)}
        say(f"    {label}: pin holds (sha256 "
            f"{fleet_scale.PINS[label]['sha256'][:16]}), "
            f"{json.dumps(fleet_scale.summary(report))}; {wall:.3f} s")
    out["pins_s"] = time.perf_counter() - t0

    say("  (b) --engine flow --topology hier --cells 32 --transports mudp "
        "at users' scale")
    captured = {}
    for label in FLOW_SCALE:
        kept, undo = _capture_calls(("fedavg",))
        calls = kept["fedavg"]
        try:
            kernels.reset_launch_counts()
            report, wall = _fleet_scale_run(label)
            launches = {k: v for k, v in kernels.launch_counts.items() if v}
        finally:
            undo()
        if launches.get("fedavg", 0) <= 0 or set(launches) != {"fedavg"}:
            raise AssertionError(f"{label}: launches {launches}; fedavg "
                                 f"must launch, and nothing else")
        n = str(report["meta"]["clients"][0])
        cell_wall = report["wall"][n]["mudp"]
        scaling = report["scaling"][0]
        by_shape = _hold_fedavg_calls(label, calls)
        rec = {"wall_s": wall, "cell_wall_s": cell_wall["wall_s"],
               "rounds_per_wall_sec": cell_wall["rounds_per_wall_sec"],
               "wall_s_per_client": scaling["wall_s_per_client"],
               "launches": launches, "calls_by_shape": by_shape,
               "summary": fleet_scale.summary(report)}
        say(f"    {label}: pin holds; cell wall {cell_wall['wall_s']:.3f} "
            f"s ({wall:.3f} s with the entry point), "
            f"{cell_wall['rounds_per_wall_sec']:.6f} rounds per wall s, "
            f"{scaling['wall_s_per_client'] * 1e6:.3f} us wall per client; "
            f"{json.dumps(rec['summary'])}")
        say(f"      fedavg: {launches['fedavg']} launches, each bitwise "
            f"against the plain version and the numpy fold; calls by shape "
            f"{json.dumps(by_shape)}")
        out["scale"][label] = rec
        captured[label] = calls

    args = fleet_scale.parse_args([*fleet_scale.PINNED_ARGV[FLOW_SCALE[0]],
                                   "--device", FLOW_DEVICE])
    prof = fleet_scale.profile(os.path.join(FLOW_OUT, "profile.json"),
                               args, "mudp")
    say(f"    one profiled round at 10,000 clients: wall "
        f"{prof['wall_s']:.6f} s, device busy "
        f"{prof['device_busy_s'] * 1e3:.3f} ms, idle share "
        f"{prof['idle_share']:.6f} ({prof['device_events']} device "
        f"events); device us by kernel "
        f"{json.dumps(dict(list(prof['top_device_us'].items())[:3]))}")
    out["profile_10000"] = {k: v for k, v in prof.items()
                            if k != "top_device_us"}
    out["scale_s"] = time.perf_counter() - t0 - out["pins_s"]

    say(f"  (c) the flow gate at {FLOW_GATE_CLIENTS} clients, through the "
        f"entry point in a process of its own")
    gate_json = os.path.join(FLOW_OUT, "flow_gate.json")
    _run_module("fleet_scale --flow-gate", [
        "repro_torch.fleet_scale", "--engine", "flow", "--clients", "64",
        "--rounds", "2", "--transports", "mudp", "--flow-gate",
        "--flow-gate-clients", str(FLOW_GATE_CLIENTS), "--flow-gate-min",
        str(FLOW_GATE_MIN), "--device", FLOW_DEVICE, "--out", gate_json])
    with open(gate_json) as f:
        gate = json.load(f)["flow_gate"]
    say(f"    flow {gate['flow']['events_per_sec']:.1f} / batched "
        f"{gate['batched']['events_per_sec']:.1f} packet events per wall s "
        f"= {gate['ratio']:.4f}x (floor {FLOW_GATE_MIN}x; packet events "
        f"{gate['flow']['packet_events']} / "
        f"{gate['batched']['packet_events']})")
    out["flow_gate"] = gate

    say("  (d) fedavg at the (K, 2048) stacks of (b): each run's largest, "
        "median and smallest cell, and the root")
    timed = []
    for label, calls in captured.items():
        cells = sorted((c for c in calls if c[0].shape[0] != 32),
                       key=lambda c: c[0].shape[0])
        root = [c for c in calls if c[0].shape[0] == 32][:1]
        picks = ([cells[-1], cells[len(cells) // 2], cells[0]]
                 if cells else []) + root
        for stack, w, _ in picks:
            rec = _time_fedavg(stack, w)
            timed.append(dict(rec, run=label))
    out["fedavg"] = timed
    out["phase_s"] = time.perf_counter() - t0
    return out


# --------------------------------------------------------------------------
# Phase 13: the paper's experiment and the reference's benchmark gates
# --------------------------------------------------------------------------
SIMCORE_ARGS = {"clients": 64, "payload_kib": 256, "params": 32_768,
                "seed": 0, "repeats": 2}          # the reference CI's
WIRE_PARAMS, WIRE_REPEATS = 250_000, 3             # the reference CI's
BENCH_OUT = os.path.join(HERE, "build", "port_bench")


#: the four wire kernels' wrappers with their plain versions
WIRE_WRAPPERS = ("quantize", "dequantize", "topk_gather", "topk_scatter")


def _hold_wire_calls(label: str, calls: dict) -> dict:
    """Each quantize, dequantize, gather and scatter call of a run, bitwise
    against its plain version on the same inputs (``calls``: by name, as
    ``_capture_calls`` keeps them; one sync for all); returns the calls
    held by kernel."""
    import torch
    from repro_torch.kernels.quantize import ref as quant_ref
    from repro_torch.kernels.topk import ref as topk_ref
    plain = {"quantize": quant_ref.quantize,
             "dequantize": quant_ref.dequantize,
             "topk_gather": topk_ref.gather, "topk_scatter": topk_ref.scatter}

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    differ, held = [], {}
    for name in WIRE_WRAPPERS:
        for call in calls.get(name, ()):
            want, got = plain[name](*call[:-1]), call[-1]
            pairs = zip(want, got) if name == "quantize" else [(want, got)]
            for w, g in pairs:
                if w.shape != g.shape:
                    raise AssertionError(f"{label}: {name} shape "
                                         f"{tuple(g.shape)} != plain "
                                         f"{tuple(w.shape)}")
                differ.append((bits(w) != bits(g)).any())
        if calls.get(name):
            held[name] = len(calls[name])
    if differ and bool(torch.stack(differ).any()):
        raise AssertionError(f"{label}: a wire kernel's call disagrees "
                             f"with its plain version")
    return held


def _phase13_part(tag: str, fn):
    """Run one part of phase 13 on the card with the launch counts zeroed
    just before and read just after, the five FL kernels' calls counted by
    shape, every fedavg call held bitwise against the plain version and
    the numpy fold and every wire kernel call against its plain version;
    returns ``(fn's result, record)``."""
    import torch
    from repro_torch import kernels
    calls, undo_capture = _capture_calls([n for _, n in FL_WRAPPERS])
    counters, undo = _calls_by_shape()
    t0 = time.perf_counter()
    try:
        kernels.reset_launch_counts()
        result = fn()
        torch.cuda.synchronize()
        launches = {k: v for k, v in kernels.launch_counts.items() if v}
    finally:
        undo()
        undo_capture()
    wall = time.perf_counter() - t0
    rec = {"wall_s": wall, "launches": launches,
           "calls_by_shape": {name: dict(c.most_common())
                              for name, c in counters.items() if c}}
    held = ""
    if calls["fedavg"]:
        rec["fedavg_held"] = _hold_fedavg_calls(tag, calls["fedavg"])
        held += (f"; every fedavg call bitwise against the plain version "
                 f"and the numpy fold, by shape "
                 f"{json.dumps(rec['fedavg_held'])}")
    wire_held = _hold_wire_calls(tag, calls)
    if wire_held:
        rec["wire_held"] = wire_held
        held += (f"; every wire kernel call bitwise against its plain "
                 f"version, calls {json.dumps(wire_held)}")
    say(f"    {tag}: {wall:.3f} s; launches {json.dumps(launches)}; calls "
        f"by shape {json.dumps(rec['calls_by_shape'])}{held}")
    return result, rec


def _require(tag: str, failures: list[str]) -> None:
    for msg in failures:
        say(f"    GATE FAILED: {tag}: {msg}")
    if failures:
        raise AssertionError(f"{tag}: {len(failures)} gate(s) failed: "
                             f"{failures[0]}")


def run_paper_and_gates() -> dict:
    """Phase 13: the paper's experiment and the reference's benchmark gates
    through the port's entry points on the card, each part a path of its
    own (launches zeroed before, read after): (a) the paper's §V cases,
    (b) the quickstart (no kernel may launch: Eq. 1 folds on the host),
    (c) transport_scenarios, transport_comparison --rounds 1 and
    transport_ablation, (d) fl_convergence, (e) adaptive_bench --check,
    (f) simcore at the reference CI's size, (g) wire_bench --check
    --params 250000.  Every row, record and digest against the
    reference's pins; every fedavg call bitwise against the numpy fold,
    every wire kernel call against its plain version."""
    from repro_torch import (adaptive_bench, fl_convergence, paper_cases,
                             quickstart, simcore, transport_ablation,
                             transport_comparison, transport_scenarios,
                             wire_bench)
    from repro_torch import device as _device
    out: dict = {"parts": {}}
    t_phase = time.perf_counter()

    say("  (a) the paper's §V cases on the port's MUDP")
    (records, failures), rec = _phase13_part(
        "paper_cases", paper_cases.run)
    _require("paper_cases", failures)
    for name, r in records.items():
        say(f"    {name}: pin holds; {json.dumps(paper_cases.summary(r))}")
    out["parts"]["a"] = rec

    say("  (b) the quickstart: 784-32-10 MLP on the card, hex over mudp, "
        "Eq. 1")
    (report, failures), rec = _phase13_part(
        "quickstart", lambda: quickstart.run(device="cuda"))
    _require("quickstart", failures)
    if rec["launches"]:
        raise AssertionError(f"quickstart launched {rec['launches']}; "
                             f"pairwise Eq. 1 folds on the host")
    say(f"    accuracy {report['acc0']:.6f} -> {report['acc1']:.6f}; round "
        f"record and trace lines equal their pins: "
        f"{json.dumps({k: report['round'][k] for k in ('duration_ns', 'packets_sent', 'packets_dropped', 'retransmissions')})}")
    out["parts"]["b"] = dict(rec, acc0=report["acc0"], acc1=report["acc1"])

    say("  (c) transport_scenarios, transport_comparison --rounds 1, "
        "transport_ablation")

    def transports():
        with _device.use_device("cuda"):
            rows_s, fail_s = transport_scenarios.run()
        rows_c, fail_c = transport_comparison.run_sweep(1, "cuda")
        lines, fail_a = transport_ablation.run_table("cuda")
        return rows_s, rows_c, lines, fail_s + fail_c + fail_a
    (rows_s, rows_c, lines, failures), rec = _phase13_part(
        "transports", transports)
    _require("transports", failures)
    if rec["launches"].get("fedavg", 0) <= 0:
        raise AssertionError("transport_comparison: fedavg never launched")
    say(f"    {len(rows_s)} scenario rows, {len(rows_c)} comparison rows "
        f"and {len(lines) - 1} ablation lines equal their pins; e.g. "
        f"{rows_s[1][0]}: {rows_s[1][2]}; {rows_c[-1][0]}: {rows_c[-1][2]}")
    out["parts"]["c"] = rec

    say("  (d) fl_convergence: 2 clients, 6 rounds, four arms, FedAvg on "
        "the card")
    (arms, failures), rec = _phase13_part(
        "fl_convergence", lambda: fl_convergence.run_arms(device="cuda"))
    _require("fl_convergence", failures)
    if rec["launches"].get("fedavg", 0) <= 0:
        raise AssertionError("fl_convergence: fedavg never launched")
    say("    " + "; ".join(f"{name} {arm['accuracy']:.6f}"
                           for name, arm in arms.items())
        + f" (each within {fl_convergence.ACC_TOL} of the reference's; "
        f"round records equal their pins)")
    out["parts"]["d"] = dict(rec, accuracy={n: a["accuracy"]
                                            for n, a in arms.items()})

    say("  (e) adaptive_bench --check: 32 clients, mudp+fec, each static "
        "tier against adaptive; the 24 digests under control='static'")

    def adaptive():
        with _device.use_device("cuda"):
            return adaptive_bench.run_check()
    (report, failures), rec = _phase13_part("adaptive_bench", adaptive)
    _require("adaptive_bench", failures)
    for name in ("fedavg", "quantize", "dequantize", "topk_gather",
                 "topk_scatter"):
        if rec["launches"].get(name, 0) <= 0:
            raise AssertionError(f"adaptive_bench: {name} never launched")
    say("    " + "; ".join(
        f"{name} {cell['rounds_to_target']} rounds, "
        f"{cell['sim_ns_to_target']} ns" for name, cell
        in report["arms"].items()) + "; every arm equals its pin, both "
        "gates hold")
    out["parts"]["e"] = rec

    say(f"  (f) simcore {SIMCORE_ARGS}: both engines, digests against the "
        f"reference's")

    def sim():
        with _device.use_device("cuda"):
            return simcore.run(**SIMCORE_ARGS)
    (report, failures), rec = _phase13_part("simcore", sim)
    _require("simcore", failures)
    if not report["pinned"] or rec["launches"].get("fedavg", 0) <= 0:
        raise AssertionError("simcore: not at the pinned size, or fedavg "
                             "never launched")
    os.makedirs(BENCH_OUT, exist_ok=True)
    with open(os.path.join(BENCH_OUT, "simcore.json"), "w") as f:
        json.dump(report, f, indent=1, sort_keys=True)
    for w, cells in report["cells"].items():
        say(f"    {w}: " + "; ".join(
            f"{tr} {cell['speedup_events_per_sec']:.2f}x, "
            f"{cell['batched']['events_per_sec']:.0f} events/s"
            for tr, cell in cells.items()) + " (batched / per_packet, no "
            "floor); digests equal their pins")
    out["parts"]["f"] = dict(rec, speedups={
        f"{w}/{tr}": c["speedup_events_per_sec"]
        for w, cells in report["cells"].items() for tr, c in cells.items()})

    say(f"  (g) wire_bench --check --params {WIRE_PARAMS}")

    def wire():
        with _device.use_device("cuda"):
            return wire_bench.run(WIRE_PARAMS, WIRE_REPEATS)
    (report, failures), rec = _phase13_part("wire_bench", wire)
    _require("wire_bench", failures)
    for name in WIRE_WRAPPERS:
        if rec["launches"].get(name, 0) <= 0:
            raise AssertionError(f"wire_bench: {name} never launched")
    for p in report["pipelines"]:
        say(f"    {p['spec']}: {p['bytes_per_param']:.3f} B/param, encode "
            f"{p['encode_mb_s']:.0f} MB/s, decode {p['decode_mb_s']:.0f} "
            f"MB/s, max_err {p['max_abs_err']:.2e}")
    at_gate = {}
    for backend, sweep in report["batch_sweep"].items():
        at_gate[backend] = {e["spec"]: e["points"][-1]["speedup"]
                            for e in sweep}
        say(f"    batch / loop at {wire_bench.BATCH_GATE_CLIENTS} clients, "
            f"{backend} backend: " + "; ".join(
                f"{spec} {x:.2f}x" for spec, x in at_gate[backend].items())
            + (f" (floor {wire_bench.BATCH_GATE_SPEEDUP}x for one spec)"
               if backend == wire_bench.BATCH_GATE_BACKEND
               else " (printed, not held)"))
    say("    wire bytes equal their pins under both backends; batch bytes "
        "equal the loop's")
    out["parts"]["g"] = dict(rec, batch_speedup_at_256=at_gate)
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# --------------------------------------------------------------------------
# Phase 14: the mesh tooling on one card
# --------------------------------------------------------------------------
# (a) the pod-axis FL aggregation at hymba-1.5b's published width, stacked
# for POD_COUNT pods, each the seeded parameters plus a seeded pod's own
# perturbation of POD_NOISE standard deviations
POD_ARCH, POD_COUNT, POD_NOISE = "hymba-1.5b", 4, 1e-2
# (b) the dry-run's estimate of the cells phases 6-8 ran, each beside the
# phase's measured peak: (label, arch, ShapeConfig fields)
DRYRUN_CELLS = (
    ("gemma3-12b prefill 2 x 2048", "gemma3-12b",
     ("prefill_2x2048", 2048, 2, "prefill", 0)),
    ("xlstm-350m prefill 4 x 2048", "xlstm-350m",
     ("prefill_4x2048", 2048, 4, "prefill", 0)),
    ("xlstm-350m AdamW train 4 x 128", "xlstm-350m",
     ("train_4x128", TRAIN["seq"], TRAIN["batch"], "train", 0)),
    ("gemma3-12b decode B = 2 over 2048 + 16", "gemma3-12b",
     ("decode_2x2066", LM_PATHS["gemma3-12b"]["prompt"] + GEN_STEPS + 2,
      2, "decode", LM_PATHS["gemma3-12b"]["prompt"] + GEN_STEPS + 2)))
#: the gemma3-12b prefill estimate's peak against the measured one
DRYRUN_PEAK_TOL = 0.15
DRYRUN_OUT = os.path.join("build", "port_dryrun")


def _swapped_fl_aggregate(mode: str, fedavg, quantize, dequantize):
    """``make_fl_aggregate`` with its three wrappers swapped for the given
    callables; returns ``(agg, undo)``."""
    import types

    from repro_torch.distributed import fl_mesh
    saved = (fl_mesh.fedavg_ops, fl_mesh.quant_ops)
    fl_mesh.fedavg_ops = types.SimpleNamespace(fedavg=fedavg)
    fl_mesh.quant_ops = types.SimpleNamespace(quantize=quantize,
                                              dequantize=dequantize)

    def undo():
        fl_mesh.fedavg_ops, fl_mesh.quant_ops = saved
    return fl_mesh.make_fl_aggregate(fl_mesh.client_mesh(), mode=mode), undo


def _timed_kernel_ms(mode: str, stacked, quantize=None) -> dict:
    """Two more aggregations, the second with each kernel call between two
    CUDA events on the stream (the wrapper places nothing else on the
    card; the first leaves the allocator holding every buffer, so no
    ``cudaMalloc`` stalls between the events): per kernel, (device ms
    summed over its calls, calls).  ``quantize``: a stand-in for the
    quantize wrapper (the parent's kernel)."""
    import torch
    from repro_torch.kernels.fedavg import ops as fedavg_ops
    from repro_torch.kernels.quantize import ops as quant_ops
    events = {"fedavg": [], "quantize": [], "dequantize": []}

    def timed(name, fn):
        def call(*args):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            stop.record()
            events[name].append((start, stop))
            return out
        return call
    agg, undo = _swapped_fl_aggregate(
        mode, timed("fedavg", fedavg_ops.fedavg),
        timed("quantize", quantize or quant_ops.quantize),
        timed("dequantize", quant_ops.dequantize))
    try:
        agg(stacked)
        for ev in events.values():
            ev.clear()
        agg(stacked)
        torch.cuda.synchronize()
    finally:
        undo()
    return {name: (sum(a.elapsed_time(b) for a, b in ev), len(ev))
            for name, ev in events.items() if ev}


def _parent_quantize(parent):
    """The parent's quantize kernel behind the wrapper's signature."""
    import torch

    def quantize(x, block):
        rows, n = x.shape
        nb = -(-n // block)
        q = torch.empty((rows, nb * block), dtype=torch.int8, device=x.device)
        scales = torch.empty((rows, nb), dtype=torch.float32,
                             device=x.device)
        parent.quantize(x, q, scales, block)
        return q, scales
    return quantize


def run_pod_aggregation(dev: str = "cuda", cfg=None, parent=None) -> dict:
    """(a) POD_ARCH's seeded parameters stacked for POD_COUNT pods, each
    with its own seeded perturbation, aggregated by
    ``make_fl_aggregate(mode="exact")`` and ``"int8"`` on the card, each
    mode a path of its own (launch counts zeroed just before and read just
    after, the FL kernels' calls counted by shape).  Holds: every leaf
    bitwise equal to the same aggregation through the plain versions on
    the card, every pod identical, the int8 float32 means within the
    codec's absmax / 254 of the exact ones a row, and fedavg (both modes),
    quantize and dequantize (int8) launched."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.distributed import fl_mesh
    from repro_torch.kernels.fedavg import ref as fedavg_ref
    from repro_torch.kernels.quantize import ref as quant_ref
    from repro_torch.models import model as M
    from repro_torch.tree import named_leaves

    dev = torch.device(dev)
    cfg = cfg or get_config(POD_ARCH)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    stacked = fl_mesh.stack_for_pods(M.init(cfg, gen, dev), POD_COUNT)
    leaves = dict(named_leaves(stacked))
    for x in leaves.values():
        for pod in x:
            pod.add_(torch.randn(pod.shape, generator=gen, device=dev,
                                 dtype=torch.float32).mul_(POD_NOISE)
                     .to(pod.dtype))
    torch.cuda.synchronize()
    per_pod = sum(x[0].numel() for x in leaves.values())
    rows = sum(x[0].numel() // x.shape[-1] for x in leaves.values())
    dtypes = sorted({str(x.dtype) for x in leaves.values()})
    gb = sum(x.numel() * x.element_size() for x in leaves.values()) / 1e9
    say(f"  {cfg.name}: {per_pod} parameters a pod ({', '.join(dtypes)}) "
        f"in {len(leaves)} leaves x {POD_COUNT} pods, {gb:.3f} GB stacked; "
        f"built in {time.perf_counter() - t0:.3f} s")
    send = {"exact": sum(x[0].numel() * x.element_size()
                         for x in leaves.values()),
            "int8": per_pod + 4 * rows}
    # each kernel's (bytes, operations), summed over the leaves: inputs
    # read once and outputs written once (float32 stacks and means, int8
    # codes, a scale a row); fedavg a multiply and an add a stacked value,
    # quantize an absmax and a divide, dequantize a multiply
    stacked_n = POD_COUNT * per_pod
    kernel_work = {"fedavg": (4 * stacked_n + 4 * per_pod, 2 * stacked_n),
                   "quantize": (5 * stacked_n + 4 * POD_COUNT * rows,
                                2 * stacked_n),
                   "dequantize": (5 * stacked_n + 4 * POD_COUNT * rows,
                                  stacked_n)}
    out = {"arch": cfg.name, "pods": POD_COUNT, "params_per_pod": per_pod,
           "leaves": len(leaves), "rows_per_pod": rows, "modes": {}}
    for mode in fl_mesh.MODES:
        agg = fl_mesh.make_fl_aggregate(fl_mesh.client_mesh(), mode=mode)
        counters, undo = _calls_by_shape()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        try:
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            result = agg(stacked)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {k: v for k, v in kernels.launch_counts.items() if v}
        finally:
            undo()
        peak = torch.cuda.max_memory_allocated() / 1e9
        by_shape = {name: dict(c.most_common())
                    for name, c in counters.items() if c}
        want = ({"fedavg"} if mode == "exact"
                else {"fedavg", "quantize", "dequantize"})
        if set(launches) != want:
            raise AssertionError(f"pod aggregation {mode}: launches "
                                 f"{launches}, want each of {sorted(want)}")
        got_leaves = dict(named_leaves(result))
        say(f"  {mode}: {wall:.6f} s wall (ending in a synchronize); "
            f"launches {json.dumps(launches)}; calls by shape "
            f"{json.dumps(by_shape)}; each pod would send {send[mode]} B "
            f"({send[mode] / per_pod:.4f} B a parameter); peak memory "
            f"{peak:.3f} GB")
        plain, undo = _swapped_fl_aggregate(
            mode, fedavg_ref.fedavg, quant_ref.quantize, quant_ref.dequantize)
        differ = []
        try:
            for name, x in leaves.items():
                got = got_leaves[name]
                ref = plain({"x": x})["x"]
                differ.append((got.view(torch.int16 if got.element_size()
                                        == 2 else torch.int32)
                               != ref.view(torch.int16 if ref.element_size()
                                           == 2 else torch.int32)).any())
                differ.append((got != got[:1]).any())
                del ref
        finally:
            undo()
        if bool(torch.stack(differ).any()):
            raise AssertionError(f"pod aggregation {mode}: a leaf differs "
                                 f"from the plain versions' or between "
                                 f"pods")
        say(f"  {mode}: every leaf bitwise equal to the plain versions' "
            f"aggregation on the card; every pod identical")
        del result, got_leaves
        torch.cuda.empty_cache()
        timed = _timed_kernel_ms(mode, stacked)
        kernel_ms = {}
        for name in sorted(want):
            ms, n = timed[name]
            nbytes, flops = kernel_work[name]
            bound, by = bound_ms(nbytes, flops)
            kernel_ms[name] = {"device_ms": ms, "calls": n,
                               "bytes": nbytes, "bound_ms": bound,
                               "bound_by": by}
            say(f"    {name}: device {ms:.6f} ms over {n} calls; bound "
                f"{bound:.6f} ms ({by}: {nbytes} B, {flops} float32 "
                f"operations; {bound / ms if ms else 0:.3f} of it)")
        if mode == "int8" and parent is not None and parent.has("quantize"):
            # in turns: parent, this, this, parent
            old_q = _parent_quantize(parent)
            turns, calls = zip(*(_timed_kernel_ms(mode, stacked,
                                                  q)["quantize"]
                                 for q in (old_q, None, None, old_q)))
            rec = kernel_ms["quantize"]
            rec.update(parent_device_ms=turns[::3], turns_ms=turns[1:3])
            ratio = statistics.mean(turns[1:3]) / statistics.mean(turns[::3])
            say(f"    parent's quantize: device {turns[0]:.6f} / "
                f"{turns[3]:.6f} ms over its {calls[0]} calls (before / "
                f"after); this one {turns[1]:.6f} / {turns[2]:.6f} between "
                f"them ({rec['device_ms']:.6f} above), {ratio:.3f} of it; "
                f"bound {rec['bound_ms']:.6f} ms")
        out["modes"][mode] = {"wall_s": wall, "launches": launches,
                              "calls_by_shape": by_shape,
                              "bytes_sent_per_pod": send[mode],
                              "peak_gb": peak, "kernels": kernel_ms}
    worst, over = 0.0, []
    for name, x in leaves.items():
        exact = fl_mesh.pod_mean(x, "exact")
        int8 = fl_mesh.pod_mean(x, "int8")
        bound = x.abs().amax(dim=(0, x.dim() - 1)).double() / 254
        err = (int8.double() - exact.double()).abs().amax(dim=-1)
        worst = max(worst, float((err / bound).max()))
        if bool((err > bound).any()):
            over.append(name)
    say(f"  int8 vs exact float32 means: the largest row error "
        f"{worst:.4f} of the row's absmax / 254 (hold 1.0)")
    if over:
        raise AssertionError(f"pod aggregation: int8 off the exact mean by "
                             f"more than absmax / 254 at {over}")
    out["int8_err_share_of_bound"] = worst
    del stacked, leaves
    torch.cuda.empty_cache()
    return out


def run_dryrun_cells(lm: dict, train_rec: dict) -> list[dict]:
    """(b) The dry-run's estimate of each DRYRUN_CELLS cell beside the
    phase that ran it: estimated and model FLOPs, the useful ratio, the
    estimated and measured peaks, and the phase's model-FLOP rate against
    the bf16 peak.  Holds the gemma3-12b prefill's peak within
    DRYRUN_PEAK_TOL of the one measured just after that prefill."""
    import dataclasses

    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.launch import lowering

    measured = {
        "gemma3-12b prefill 2 x 2048": (
            lm["gemma3-12b"][1]["peak_prefill_gb"],
            lm["gemma3-12b"][1]["prefill_s"]),
        "xlstm-350m prefill 4 x 2048": (
            lm["xlstm-350m"][1]["peak_prefill_gb"],
            lm["xlstm-350m"][1]["prefill_s"]),
        "xlstm-350m AdamW train 4 x 128": (train_rec["peak_steps_gb"],
                                           train_rec["s_per_step"]),
        "gemma3-12b decode B = 2 over 2048 + 16": (
            lm["gemma3-12b"][1]["peak_gb"],
            lm["gemma3-12b"][1]["decode_step_median_s"])}
    train_cfg = TrainConfig(learning_rate=1e-3, warmup_steps=10,
                            total_steps=100, remat_policy="none")
    out = []
    for label, arch, dims in DRYRUN_CELLS:
        shape = ShapeConfig(*dims)
        rep = lowering.estimate_cell(
            arch, shape, train_cfg=train_cfg if shape.mode == "train"
            else None)
        if rep.status != "ok":
            raise AssertionError(f"dry-run {label}: {rep.error}")
        peak_gb, wall = measured[label]
        est_gb = rep.bytes_per_device / 1e9
        gap = est_gb / peak_gb - 1
        rate = rep.model_flops_global / wall
        what = ("the peak of phase 6's prefill and decode"
                if shape.mode == "decode" else
                "the peak just after the prefill"
                if shape.mode == "prefill" else
                "the peak over phase 8's unprofiled steps")
        say(f"  {label}: estimated {rep.hlo_flops:.4e} FLOPs, model "
            f"{rep.model_flops_global:.4e} (useful {rep.useful_ratio:.4f}); "
            f"estimated peak {est_gb:.3f} GB, measured {peak_gb:.3f} GB "
            f"({what}), gap {gap:+.4f}"
            + (f" (hold {DRYRUN_PEAK_TOL})" if label == DRYRUN_CELLS[0][0]
               else " (printed)")
            + f"; the phase's wall {wall:.6f} s: model FLOPs "
            f"{rate / 1e12:.3f} TFLOP/s = {rate / PEAK_BF16_FLOPS:.5f} of "
            f"989 TFLOP/s; trace {rep.compile_seconds:.3f} s")
        out.append(dict(dataclasses.asdict(rep), label=label,
                        measured_peak_gb=peak_gb, peak_gap=gap,
                        phase_wall_s=wall, model_flop_rate=rate))
    if abs(out[0]["peak_gap"]) > DRYRUN_PEAK_TOL:
        raise AssertionError(f"dry-run {out[0]['label']}: estimated peak "
                             f"off the measured one by "
                             f"{out[0]['peak_gap']:+.4f}")
    return out


def run_mesh_tooling(lm: dict, train_rec: dict, parent=None) -> dict:
    """Phase 14: (a) the pod aggregation (under ``--parent`` also with the
    replaced quantize), (b) the dry-run against the card, (c) the dry-run
    and roofline entry points as subprocesses."""
    t_phase = time.perf_counter()
    say(f"  (a) pod aggregation: {POD_ARCH} x {POD_COUNT} pods, exact and "
        f"int8")
    pods = run_pod_aggregation(parent=parent)
    say("  (b) the dry-run's estimates of phases 6-8's cells")
    cells = run_dryrun_cells(lm, train_rec)
    say("  (c) the entry points")
    os.makedirs(os.path.join(HERE, DRYRUN_OUT), exist_ok=True)
    _run_module("dryrun", ["repro_torch.launch.dryrun", "--arch",
                           "xlstm-350m", "--shape", "prefill_32k", "--out",
                           os.path.join(DRYRUN_OUT, "dryrun_phase14.json")],
                timeout=120)
    _run_module("roofline", ["repro_torch.roofline"], timeout=60)
    return {"pods": pods, "dryrun": cells,
            "phase_s": time.perf_counter() - t_phase}


#: Every kernel's wrapper, by (family, wrapper name), for phase 15's calls
#: by shape.
ALL_WRAPPERS = FL_WRAPPERS + (("checksum", "chunksum32"),
                              ("flash_attention", "flash_attention"),
                              ("mlstm", "mlstm"))


def kernel_row_split() -> dict:
    """The aggregation and kernels suites through ``bench_run.main`` on
    the card, in the harness's order, each kernels-suite row taken apart:
    each call of its wrapper or plain version (the warm call first) as
    host time to the call's return, the wait in a synchronize just after,
    the span between CUDA events around it (on an idle card the span is
    the host's enqueue time, not the kernel's) and the segments the
    caching allocator took from ``cudaMalloc`` in it; and the row's timed
    reps as their wall (the probe's own reads included), the calls' share
    of it and the time the garbage collector ran inside it
    (``gc.callbacks``, with the generations).  Returns, by row, its wall
    a rep and that record."""
    import contextlib
    import gc
    import io

    import torch
    from repro_torch import bench_run, kernels_bench
    collections_: list[tuple[float, float, int]] = []
    started = [0.0]

    def on_gc(phase, info):
        if phase == "start":
            started[0] = time.perf_counter()
        else:
            collections_.append((started[0], time.perf_counter(),
                                 info["generation"]))

    calls: dict[str, list] = {}

    def segments() -> int:
        return torch.cuda.memory_stats().get("segment.all.allocated", 0)

    def split(row, fn):
        def timed(*args):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            seg0 = segments()
            t0 = time.perf_counter()
            ev[0].record()
            out = fn(*args)
            ev[1].record()
            t1 = time.perf_counter()
            ev[1].synchronize()
            calls[row].append((t0, t1, time.perf_counter(),
                               ev[0].elapsed_time(ev[1]) * 1e3,
                               segments() - seg0))
            return out
        timed.row = row
        calls[row] = []
        return timed

    windows: dict[str, tuple[float, float]] = {}
    time_row = kernels_bench._time

    def timed_row(fn, args, reps, dev):
        out = time_row(fn, args, reps, dev)
        windows[fn.row] = (calls[fn.row][0][2], time.perf_counter())
        return out

    saved = dict(kernels_bench.PAIRS)
    suites = dict(bench_run.SUITES)
    gc.callbacks.append(on_gc)
    try:
        for name, (wrapper, plain, reps) in saved.items():
            kernels_bench.PAIRS[name] = (split(f"kernels/{name}_kernel",
                                               wrapper),
                                         split(f"kernels/{name}_ref", plain),
                                         reps)
        kernels_bench._time = timed_row
        bench_run.SUITES.clear()
        bench_run.SUITES.update((k, suites[k])
                                for k in ("aggregation", "kernels"))
        with contextlib.redirect_stdout(io.StringIO()) as out:
            rc = bench_run.main(["--device", "cuda"])
    finally:
        gc.callbacks.remove(on_gc)
        kernels_bench.PAIRS.update(saved)
        kernels_bench._time = time_row
        bench_run.SUITES.clear()
        bench_run.SUITES.update(suites)
    if rc != 0:
        raise AssertionError(f"bench_run aggregation, kernels returned {rc}")
    result = {}
    for row, us, _ in bench_run.parse(out.getvalue()):
        if row not in windows:
            continue
        lo, hi = windows[row]
        in_gc = [(min(e, hi) - max(s, lo), g) for s, e, g in collections_
                 if e > lo and s < hi]
        result[row] = {
            "us": us, "reps_us": round((hi - lo) * 1e6, 1),
            "calls_us": round(sum(c[2] - c[0] for c in calls[row][1:])
                              * 1e6, 1),
            "gc_us": round(sum(d for d, _ in in_gc) * 1e6, 1),
            "gc_generations": [g for _, g in in_gc],
            "calls": [[round((c[1] - c[0]) * 1e6, 1),
                       round((c[2] - c[1]) * 1e6, 1), round(c[3], 1), c[4]]
                      for c in calls[row]]}
    return result


def _say_row_split(tag: str, split: dict) -> None:
    for row, r in split.items():
        say(f"    {tag} {row} {r['us']:.1f} us: reps {r['reps_us']} us, "
            f"calls {r['calls_us']}, gc {r['gc_us']} (generations "
            f"{r['gc_generations']}); each call host, sync, event span us, "
            f"new segments {json.dumps(r['calls'])}")


def run_bench_harness() -> dict:
    """Phase 15: the reference's benchmark harness on the port, (a)
    ``bench_run.main(["--device", "cuda"])`` in this process (its output
    captured; the launch counts zeroed just before and read just after,
    each suite's launches, calls by shape and wall recorded around it;
    every call of the five FL kernels kept and held bitwise after the
    run: fedavg against its plain version and the numpy fold, the wire
    kernels against their plain versions), then (b) ``python -m
    repro_torch.bench_run --only kernels`` in a process of its own, which
    must exit 0, and (c) the aggregation and kernels suites again, each
    kernels row taken apart (:func:`kernel_row_split`), in this process
    and in a fresh one.  Fails
    on a suite error, a missing or extra row, a deterministic field off
    its pin, a kernel row not on the ``cuda`` route, a kernel call off its
    plain version, and on any of the eight kernels not launched by (a)."""
    import contextlib
    import io

    import torch
    from repro_torch import bench_run, kernels

    def off_route(rows) -> list[str]:
        return [f"{row}: {derived}" for row, _, derived in rows
                if row.startswith("kernels/") and row.endswith("_kernel")
                and not derived.endswith(";route=cuda")]

    suites: dict[str, dict] = {}

    def counted(name, bench):
        def run():
            torch.cuda.synchronize()
            launches0 = dict(kernels.launch_counts)
            shapes0 = {k: c.copy() for k, c in counters.items()}
            t0 = time.perf_counter()
            try:
                return list(bench())
            finally:
                torch.cuda.synchronize()
                suites[name] = {
                    "wall_s": time.perf_counter() - t0,
                    "launches": {k: v - launches0[k] for k, v
                                 in kernels.launch_counts.items()
                                 if v > launches0[k]},
                    "calls_by_shape": {
                        k: dict((c - shapes0[k]).most_common())
                        for k, c in counters.items() if c - shapes0[k]}}
        return run

    saved = dict(bench_run.SUITES)
    kept, undo_capture = _capture_calls([n for _, n in FL_WRAPPERS])
    counters, undo = _calls_by_shape(ALL_WRAPPERS)
    t0 = time.perf_counter()
    try:
        for name, bench in saved.items():
            bench_run.SUITES[name] = counted(name, bench)
        kernels.reset_launch_counts()
        with contextlib.redirect_stdout(io.StringIO()) as out:
            rc = bench_run.main(["--device", "cuda"])
        launches = {k: v for k, v in kernels.launch_counts.items() if v}
    finally:
        bench_run.SUITES.update(saved)
        undo()
        undo_capture()
    wall = time.perf_counter() - t0
    text = out.getvalue()
    for line in text.splitlines():
        say(f"    {line}")
    for name, rec in suites.items():
        say(f"    (a) {name}: {rec['wall_s']:.3f} s; launches "
            f"{json.dumps(rec['launches'])}; calls by shape "
            f"{json.dumps(rec['calls_by_shape'])}")
    rows = bench_run.parse(text)
    fails = bench_run.failures(rows) + off_route(rows)
    if rc != 0:
        fails.append(f"bench_run.main returned {rc}")
    never = [name for name in kernels.launch_counts if not launches.get(name)]
    if never:
        fails.append(f"kernels never launched by the harness: {never}")
    t_held = time.perf_counter()
    held = {}
    try:
        if kept["fedavg"]:
            held["fedavg"] = _hold_fedavg_calls("phase 15 (a)",
                                                kept["fedavg"])
        held.update(_hold_wire_calls("phase 15 (a)", kept))
    except AssertionError as e:
        fails.append(str(e))
    del kept
    held_s = time.perf_counter() - t_held
    _require("phase 15 (a)", fails)
    say(f"  (a) {wall:.3f} s; {len(rows)} rows, every pin holds, every "
        f"kernel row on the cuda route; launches {json.dumps(launches)}")
    say(f"  (a) every FL kernel call bitwise against its plain version "
        f"(fedavg also the numpy fold) in {held_s:.3f} s: fedavg by shape "
        f"{json.dumps(held.pop('fedavg', {}))}, wire calls "
        f"{json.dumps(held)}")

    t1 = time.perf_counter()
    lines = _run_module("(b) bench_run --only kernels",
                        ["repro_torch.bench_run", "--only", "kernels"])
    sub = bench_run.parse("\n".join(lines))
    _require("phase 15 (b)", bench_run.failures(sub, suites=["kernels"])
             + off_route(sub))
    cli_s = time.perf_counter() - t1

    say("  (c) the aggregation and kernels suites again, each kernels row "
        "taken apart: its reps' wall, the calls' share, the collector's")
    split = {"in_process": kernel_row_split()}
    code = ("import json, chip_smoke; "
            "print(json.dumps(chip_smoke.kernel_row_split()))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=HERE,
                          env=_module_env(), capture_output=True, text=True,
                          timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"phase 15 (c): the fresh process exited "
                             f"{proc.returncode}:\n{proc.stderr[-4000:]}")
    split["fresh_process"] = json.loads(proc.stdout.splitlines()[-1])
    for tag, rec in split.items():
        _say_row_split(tag, rec)
    return {"wall_s": wall, "launches": launches, "suites": suites,
            "rows": len(rows), "held_s": held_s, "kernels_cli_s": cli_s,
            "row_split": split}


def _ptxas_lines(log: str) -> list[tuple[str, str]]:
    """(kernel, line) for each register, spill and wgmma line of an
    ``nvcc -Xptxas=-v`` log; the kernel as ``name<template args>``."""
    out, entry = [], "?"
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(_Z\w+)", line)
        if m:
            mangled = m.group(1)
            args = re.findall(r"Li(\d+)E", mangled)
            dtype = ("bf16," if "bfloat16" in mangled else
                     "f32," if re.search(r"IfLi", mangled) else "")
            name = re.search(r"[a-z][a-z_]*_kernel", mangled)
            entry = (f"{name.group(0)}<{dtype}{','.join(args)}>" if name
                     else mangled[:60])
        elif "registers" in line or "spill" in line or "wgmma" in line:
            out.append((entry, line.strip().removeprefix("ptxas info    : ")))
    return out


def _say_wgmma_resources() -> None:
    """Each tensor-core kernel's registers and spills (from ptxas) and
    dynamic shared memory a CTA: flash attention at each head width, the
    mLSTM at dh 512; fails on a spill."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.mlstm import ops as mlstm_ops
    cases = [("flash_attention", f"flash_wgmma_kernel<bf16,{hd},",
              f"flash_wgmma_kernel hd {hd}",
              flash_ops.smem_bytes(torch.bfloat16, hd)) for hd in (64, 128, 256)]
    cases.append(("mlstm", "mlstm_wgmma_kernel<bf16,", "mlstm_wgmma_kernel dh 512",
                  mlstm_ops.smem_bytes()))
    lines = {fam: _ptxas_lines((_build.BUILD_DIR / f"{fam}.log").read_text())
             for fam in ("flash_attention", "mlstm")}
    for fam, prefix, label, smem in cases:
        mine = [line for entry, line in lines[fam] if entry.startswith(prefix)]
        say(f"  {label}: {'; '.join(mine)}; dynamic smem {smem} bytes a CTA")
        spills = [int(n) for line in mine
                  for n in re.findall(r"(\d+) bytes spill", line)]
        if not spills or any(spills):
            raise AssertionError(f"{label}: spills, or no ptxas lines: "
                                 f"{mine}")


def _say_spill_free(label: str, by_kernel: dict[str, list[str]]) -> None:
    """Print each kernel's ptxas lines; fail on a spill or a kernel with
    none."""
    for entry, mine in sorted(by_kernel.items()):
        say(f"  {entry}: {'; '.join(mine)}")
        spills = [int(n) for line in mine
                  for n in re.findall(r"(\d+) bytes spill", line)]
        if not spills or any(spills):
            raise AssertionError(f"{label} {entry}: spills, or no ptxas "
                                 f"lines: {mine}")


def _say_fl_resources() -> None:
    """The top-k scatter's and dequantize's ptxas registers and spills, and
    their shared memory a CTA: the scatter's tile is dynamic, (tile + 4)
    floats, at its path and large shapes.  Then the registers, spills and
    static shared memory of the gather, of each quantize kernel (every
    (lanes, units) of ops.QUANT_KERNELS and the wide route) and of each
    fedavg kernel; fails on a spill or a missing kernel."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.quantize import ops as quant_ops
    from repro_torch.kernels.topk import ops as topk_ops
    tiles = {key: topk_ops.scatter_tile(rows, n) for key, (rows, n, _)
             in TOPK_SHAPES["topk_scatter"].items()}
    for fam, kernel, smem in (
            ("topk", "scatter_kernel", "; ".join(
                f"{key} dynamic smem {(t + 4) * 4} bytes a CTA ({t} columns)"
                for key, t in tiles.items())),
            ("quantize", "dequantize_kernel", "no dynamic smem")):
        lines = _ptxas_lines((_build.BUILD_DIR / f"{fam}.log").read_text())
        mine = [line for entry, line in lines if entry.startswith(kernel)]
        say(f"  {kernel}: {'; '.join(mine)}; {smem}")

    def kernels_of(fam: str, prefix: str = "") -> dict[str, list[str]]:
        by_kernel: dict[str, list[str]] = {}
        for entry, line in _ptxas_lines(
                (_build.BUILD_DIR / f"{fam}.log").read_text()):
            if entry.startswith(prefix):
                by_kernel.setdefault(entry, []).append(line)
        return by_kernel
    # the gather and every quantize kernel: no spills
    gather = kernels_of("topk", "gather_kernel")
    quant = kernels_of("quantize", "quantize_")
    want = {f"quantize_lanes_kernel<{g},{u}>"
            for g, u in quant_ops.QUANT_KERNELS} | {"quantize_wide_kernel<>"}
    if len(gather) != 1 or not want <= set(quant):
        raise AssertionError(f"ptxas lines for {sorted(gather)} and "
                             f"{sorted(quant)}, not the gather and "
                             f"{sorted(want)}")
    _say_spill_free("topk", gather)
    _say_spill_free("quantize", quant)
    # fedavg: the wide kernel and each tile and stage size of the two tall
    # ones (their ring is static shared memory, on ptxas's "bytes smem");
    # no spills.
    fedavg = kernels_of("fedavg")
    if len(fedavg) != 19:
        raise AssertionError(f"fedavg: ptxas lines for {sorted(fedavg)}, "
                             f"not the 19 kernels")
    _say_spill_free("fedavg", fedavg)


def main(argv: list[str] | None = None) -> int:
    import argparse

    import torch

    from repro_torch import kernels
    from repro_torch.kernels import _build
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", metavar="DIR",
                    help="a checkout from before the quantize and top-k "
                         "gather redesigns: phases 2 and "
                         "14(a) also time its kernels beside these, in "
                         "turns")
    args = ap.parse_args(argv)
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
    parent = ParentKernels(args.parent) if args.parent else None
    per = _build.build()
    if parent is not None:
        parent.load()
    say(f"  built {sorted(per)} in {time.perf_counter() - t0:.3f} s "
        f"(per source: {json.dumps({k: round(v, 3) for k, v in per.items()})})")
    for name in sorted(per):
        log = _build.BUILD_DIR / f"{name}.log"
        if log.exists():
            for entry, line in _ptxas_lines(log.read_text()):
                say(f"  ptxas {name} {entry}: {line}")
    _say_wgmma_resources()
    _say_fl_resources()

    say("[2] kernels against their plain versions")
    rows = check_kernels(parent)

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

    lm = {}
    for phase, arch in ((6, "gemma3-12b"), (7, "xlstm-350m")):
        spec = LM_PATHS[arch]
        say(f"[{phase}] {arch} serving at full width: prefill B="
            f"{spec['batch']} P={spec['prompt']}, {GEN_STEPS} greedy steps")
        t0 = time.perf_counter()
        lm[arch] = run_lm_path(arch)
        if arch == "xlstm-350m":
            run_serve_cli()
        say(f"  phase {phase}: {time.perf_counter() - t0:.3f} s")

    say(f"[8] {TRAIN['arch']} training at full width: the training entry point "
        f"twice (resume), then {TRAIN_TIMED} timed and 2 profiled steps; "
        f"the step on the card against the CPU at smoke size")
    t0 = time.perf_counter()
    losses = run_train_cli()
    say(f"  entry-point losses over {len(losses)} steps: {losses}")
    train_rec = run_train_path()
    train_rec["holds"] = hold_train_step_cpu()
    say(f"  phase 8: {time.perf_counter() - t0:.3f} s")

    say(f"[9] fl_train_lm --scale 100m: 3 clients, WAN links, 5% uplink "
        f"loss, int8 deltas with error feedback, {LMFL_ROUNDS} rounds")
    t0 = time.perf_counter()
    counts_lmfl, by_shape_lmfl, lmfl = run_lm_fl_path()
    say(f"  phase 9: {time.perf_counter() - t0:.3f} s")

    say(f"[10] the MoE, VLM, encdec and hybrid families serving at full "
        f"width: {', '.join(FAMILY_PATHS)}; {GEN_STEPS} greedy steps "
        f"each")
    t0 = time.perf_counter()
    families = {arch: run_family_path(arch) for arch in FAMILY_PATHS}
    run_family_serve_cli()
    say(f"  phase 10: {time.perf_counter() - t0:.3f} s")

    say("[11] the rest of the fleet layer: hier, gossip, async and the vmap "
        "train backend, 48 clients")
    t0 = time.perf_counter()
    fleet_layer = run_fleet_layer()
    fleet_layer["phase_s"] = time.perf_counter() - t0
    say(f"  phase 11: {fleet_layer['phase_s']:.3f} s")

    say("[12] the flow engine at fleet scale: repro_torch.fleet_scale "
        "--engine flow, small pins, 10,000 and 100,000 clients, the flow "
        "gate, fedavg at the path's stacks")
    flow_fleet = run_flow_fleet()
    say(f"  phase 12: {flow_fleet['phase_s']:.3f} s")

    say("[13] the paper's experiment and the reference's benchmark gates: "
        "paper cases, quickstart, transport_scenarios / comparison / "
        "ablation, fl_convergence, adaptive_bench --check, simcore, "
        "wire_bench --check")
    gates = run_paper_and_gates()
    say(f"  phase 13: {gates['phase_s']:.3f} s")

    say(f"[14] the mesh tooling: the pod-axis FL aggregation ({POD_ARCH} x "
        f"{POD_COUNT} pods, exact and int8), the dry-run against phases "
        f"6-8, the dry-run and roofline entry points")
    mesh = run_mesh_tooling(lm, train_rec, parent)
    say(f"  phase 14: {mesh['phase_s']:.3f} s")

    say("[15] the reference's benchmark harness on the port: "
        "repro_torch.bench_run, all 14 suites in this process, then "
        "--only kernels in its own")
    t0 = time.perf_counter()
    harness = run_bench_harness()
    harness["phase_s"] = time.perf_counter() - t0
    say(f"  phase 15: {harness['phase_s']:.3f} s")

    # Each kernel's launches on its own path: slice 1's kernels on phase
    # 4's path (their count on the fleet path beside it), the top-k
    # kernels on the fleet path, checksum on the pass over its bodies,
    # flash attention and mLSTM on their model's serving path.
    path_counts = {"fedavg": counts_mnist, "quantize": counts_mnist,
                   "dequantize": counts_mnist, "topk_gather": counts_fleet,
                   "topk_scatter": counts_fleet, "checksum": counts_ck,
                   "flash_attention": lm["gemma3-12b"][0],
                   "mlstm": lm["xlstm-350m"][0]}
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
                    "kernel_alone_ms": rec.get("kernel_alone_ms"),
                    "bytes": rec["bytes"],
                    "copy_bound_ms": rec["copy_bound_ms"],
                    "device": rec["device"],
                    "other_shapes": {key: r for key, r in rows[name].items()
                                     if key != MAIN_SHAPE[name]}})
    for name, arch in (("flash_attention", "gemma3-12b"),
                       ("mlstm", "xlstm-350m")):
        out[list(MAIN_SHAPE).index(name)]["serving"] = dict(
            lm[arch][1], arch=arch)
    gather = out[list(MAIN_SHAPE).index("topk_gather")]
    gather.update(sector_bound_ms=rows["topk_gather"][MAIN_SHAPE[
        "topk_gather"]]["sector_bound_ms"])
    out[list(MAIN_SHAPE).index("flash_attention")].update(
        launches_family_paths={arch: counts["flash_attention"]
                               for arch, (counts, _) in families.items()},
        family_serving={arch: rec for arch, (_, rec) in families.items()})
    for name in ("fedavg", "quantize", "dequantize"):
        out[list(MAIN_SHAPE).index(name)].update(
            launches_lm_fl_path=counts_lmfl[name],
            launches_by_shape_lm_fl_path=by_shape_lmfl[name])
    hier_launches = fleet_layer["arms"]["mudp+fec/sync/hier/mlp"]
    for name in ("fedavg", "quantize", "dequantize", "topk_gather",
                 "topk_scatter"):
        out[list(MAIN_SHAPE).index(name)].update(
            launches_hier_adaptive=hier_launches["launches"][name],
            calls_by_shape_hier_adaptive=hier_launches[
                "calls_by_shape"][name])
    fedavg_rec = out[list(MAIN_SHAPE).index("fedavg")]
    fedavg_rec.update(
        launches_flow_fleet=sum(r["launches"]["fedavg"]
                                for r in flow_fleet["scale"].values()),
        calls_by_shape_flow_fleet={label: r["calls_by_shape"] for label, r
                                   in flow_fleet["scale"].items()},
        flow_fleet_shapes=flow_fleet["fedavg"])
    for name in ("fedavg", "quantize", "dequantize", "topk_gather",
                 "topk_scatter"):
        out[list(MAIN_SHAPE).index(name)].update(
            launches_phase13={part: rec["launches"].get(name, 0)
                              for part, rec in gates["parts"].items()},
            calls_by_shape_phase13={
                part: rec["calls_by_shape"][name]
                for part, rec in gates["parts"].items()
                if name in rec["calls_by_shape"]})
    for name in ("fedavg", "quantize", "dequantize"):
        out[list(MAIN_SHAPE).index(name)].update(
            launches_phase14={mode: rec["launches"].get(name, 0)
                              for mode, rec in mesh["pods"]["modes"].items()},
            calls_by_shape_phase14={
                mode: rec["calls_by_shape"][name]
                for mode, rec in mesh["pods"]["modes"].items()
                if name in rec["calls_by_shape"]})
    for rec in out:
        rec["launches_phase15"] = {
            suite: r["launches"].get(rec["name"], 0)
            for suite, r in harness["suites"].items()}
    say(json.dumps({"lm_training": train_rec, "lm_fl": lmfl,
                    "fleet_layer": fleet_layer, "flow_fleet": flow_fleet,
                    "paper_and_gates": gates, "mesh_tooling": mesh,
                    "bench_harness": harness}))
    say(f"  total {time.perf_counter() - t_start:.3f} s")
    say(json.dumps({"kernels": out}))
    say(card_line())
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
