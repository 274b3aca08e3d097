"""The port's cell estimates (``repro_torch.launch.{cost,lowering,dryrun}``
and ``repro_torch.roofline``) against the reference's lowering.

* ``model_flops`` equals the reference's for every arch x shape (``==``),
  and so do ``CellReport``'s fields (the port adds ``fits``).
* The tally counts a matmul's FLOPs as exactly ``2 * M * N * K``; a
  :func:`~repro_torch.launch.cost.steps` loop counts its trip count times
  its body (nested loops multiply) and ``raw_flops`` the body once, as
  ``hlo_cost`` multiplies a ``while`` body; views are free and freed
  storages leave the live count.
* An L-layer smoke model's prefill counts L times one layer's dot FLOPs
  (the loop property of ``tests/test_launch.py``'s scan tests).
* Loops traced three iterations deep give the FLOPs, bytes and peak of
  the loops run in full (the xLSTM's sLSTM time steps, the MoE's
  experts, a train step's microbatches), forward and backward.
* The smoke dense configurations' prefill FLOPs are within 2% of the
  reference's ``analyze_hlo_text`` on a one-device lowering of the same
  cell with ``attn_impl="einsum"`` (measured gap: 0.0, every count equal,
  at yi-9b / gemma3-12b / starcoder2-7b, B = 2, S = 64 and 256), and a
  smoke qwen2-vl-72b and yi-9b prefill's on the reference's default
  ``attn_impl="chunked"`` at S = 1024, two chunks (measured gap: 0.0).
* The chunked route (the default to prefill) costs the einsum route's
  FLOPs, and its peak lies below the einsum route's by the rows of the
  scores, their softmax and the bias that a chunk does not hold, less
  the chunk's own output, counted by hand; its chunk loop, traced three
  chunks deep, counts as the full loop.
* A VLM prefill on the reference's routes masks by its positions without
  reading them, so qwen2-vl-72b ``prefill_32k`` is costed; on the flash
  route's plain version, chosen by its positions, it reads them and
  reports ``status="error"``.  The dry-run (with ``--attn-impl`` either
  way) and roofline entry points run on one small cell.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import ARCH_IDS, SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs import smoke_variant as ref_smoke  # noqa: E402
from repro.configs.base import ShapeConfig as RefShape  # noqa: E402
from repro.launch import lowering as rlow  # noqa: E402
from repro.launch.hlo_cost import analyze_hlo_text  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro_torch import roofline  # noqa: E402
from repro_torch.configs import SHAPES, get_config, smoke_variant  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import cost, lowering  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL_GAP = 0.02


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_model_flops_and_report_fields_equal_the_reference():
    for arch in ARCH_IDS:
        for shape in REF_SHAPES:
            assert lowering.model_flops(get_config(arch), SHAPES[shape]) == \
                rlow.model_flops(ref_config(arch), REF_SHAPES[shape])
    ours = {f.name for f in dataclasses.fields(lowering.CellReport)}
    theirs = {f.name for f in dataclasses.fields(rlow.CellReport)}
    assert ours - theirs == {"fits"} and theirs <= ours


@pytest.mark.parametrize("m,k,n", [(512, 512, 512), (7, 300, 33)])
def test_matmul_flops_are_2mnk(m, k, n):
    with cost.Tally() as tally:
        meta(m, k) @ meta(k, n)
    assert tally.flops == 2 * m * n * k == tally.raw_flops
    assert tally.bytes == 4 * (m * k + k * n + m * n)
    with cost.Tally() as tally:
        torch.einsum("bij,bjk->bik", meta(3, m, k), meta(3, k, n))
    assert tally.flops == 3 * 2 * m * n * k


def test_steps_multiply_their_body_and_nest():
    a, b = meta(128, 128), meta(128, 128)
    with torch.no_grad(), cost.Tally() as tally:
        for _ in cost.steps(5):
            assert list(cost.steps(4)) == [0, 1, 2]
            for _ in cost.steps(4):
                a @ b
    assert tally.flops == 20 * 2 * 128 ** 3
    assert tally.raw_flops == 2 * 128 ** 3
    # a closed body (its own gradient inside) and one whose backward runs
    # after the loop count every iteration's forward and backward
    w = meta(128, 128).requires_grad_(True)
    with cost.Tally() as tally:
        for _ in cost.steps(6, closed=True):
            torch.autograd.grad((a @ w).sum(), w)
    assert tally.flops == 6 * tally.raw_flops == 6 * 2 * 2 * 128 ** 3
    with cost.Tally() as tally:
        total = sum((a @ w).sum() for _ in cost.steps(6))
        torch.autograd.grad(total, w)
    assert tally.flops == 6 * 2 * 2 * 128 ** 3
    assert list(cost.steps(5)) == [0, 1, 2, 3, 4]    # no tally: a range


def test_live_bytes_follow_storages():
    with cost.Tally() as tally:
        x = meta(1000)
        assert tally.live == tally.peak == 4000
        v = x.view(10, 100).t()               # views: no bytes, no storage
        assert tally.live == 4000 and tally.bytes == 0
        y = x * 2
        assert tally.live == 8000 and tally.bytes == 8000
        del x, v
        assert tally.live == 4000
        del y
        assert tally.live == 0 and tally.peak == 8000
    held = meta(10)
    with cost.Tally() as tally:
        assert tally.hold({"a": held, "b": [held.view(2, 5)]}) == 40


def _smoke(arch, layers=None):
    cfg = smoke_variant(get_config(arch))
    return cfg if layers is None else dataclasses.replace(
        cfg, num_layers=layers)


def test_prefill_counts_each_layer():
    """An L-layer prefill's dot FLOPs: L x one layer's plus the last
    position's logits, one layer's counted by hand."""
    B, S = 2, 32
    shape = ShapeConfig("p", S, B, "prefill")
    cfg = _smoke("yi-9b")
    d, hd, H, KV, F = (cfg.d_model, cfg.resolved_head_dim, cfg.num_heads,
                       cfg.num_kv_heads, cfg.d_ff)
    layer = 2 * B * S * (d * H * hd + 2 * d * KV * hd + H * hd * d
                         + 3 * d * F) + 2 * 2 * B * H * S * S * hd
    logits = 2 * B * d * cfg.padded_vocab
    for n in (1, 2, 5):
        rep = lowering.estimate_cell("yi-9b", shape,
                                     cfg=dataclasses.replace(cfg,
                                                             num_layers=n))
        assert rep.status == "ok", rep.error
        assert rep.hlo_flops == n * layer + logits


@pytest.mark.parametrize("arch,mode,remat", [
    ("xlstm-350m", "prefill", "none"), ("olmoe-1b-7b", "prefill", "none"),
    ("xlstm-350m", "decode", "none"), ("xlstm-350m", "train", "none"),
    ("xlstm-350m", "train", "full"), ("olmoe-1b-7b", "train", "none"),
    ("olmoe-1b-7b", "train", "full")])
def test_loops_traced_in_part_count_as_the_full_loops(monkeypatch, arch,
                                                      mode, remat):
    """The sLSTM's 24 time steps, the MoE's 8 experts and a train step's
    4 microbatches, each loop traced three iterations deep, give the
    FLOPs, bytes and peak of the loops run in full, forward and backward,
    with and without a checkpoint's recompute (which stops at the
    region's last saved tensor, in the last traced iteration)."""
    shape = ShapeConfig("c", 24, 4, mode, kv_len=24 if mode == "decode"
                        else 0)
    train_cfg = lowering.TrainConfig(remat_policy=remat, grad_accum=4)
    counts = []
    for full in (False, True):
        if full:
            monkeypatch.setattr(cost, "steps",
                                lambda n, closed=False: iter(range(n)))
        step, args = lowering._build_step(_smoke(arch), shape, train_cfg)
        grad = torch.enable_grad if mode == "train" else torch.no_grad
        with grad(), cost.Tally() as tally:
            tally.hold(args)
            step(*args)
        counts.append((tally.flops, tally.bytes, tally.peak))
    assert counts[0] == counts[1]


@pytest.mark.parametrize("arch", ["yi-9b", "gemma3-12b", "starcoder2-7b"])
def test_smoke_prefill_flops_match_the_reference_hlo(arch):
    B, S = 2, 64
    ref_cfg = ref_smoke(ref_config(arch))
    ins = RM.input_specs(ref_cfg, RefShape("p", S, B, "prefill"))
    compiled = jax.jit(RM.make_prefill_step(ref_cfg, attn_impl="einsum")
                       ).lower(RM.abstract_params(ref_cfg),
                               ins["batch"]).compile()
    want = analyze_hlo_text(compiled.as_text()).flops
    rep = lowering.estimate_cell(arch, ShapeConfig("p", S, B, "prefill"),
                                 cfg=_smoke(arch))
    assert rep.status == "ok", rep.error
    assert abs(rep.hlo_flops - want) <= REL_GAP * want


def test_train_and_decode_cells_report_their_terms():
    shape = ShapeConfig("t", 16, 4, "train")
    rep = lowering.estimate_cell("gemma3-12b", shape, cfg=_smoke("gemma3-12b"))
    assert rep.status == "ok", rep.error
    # 4 sequences of 16 tokens: 1 microbatch of 64 tokens
    assert lowering.auto_grad_accum(shape) == 1
    assert lowering.auto_grad_accum(SHAPES["train_4k"]) == 256
    assert rep.hlo_flops > rep.model_flops_global > 0
    assert rep.bytes_per_device >= rep.argument_bytes > 0
    assert rep.hlo_bytes > rep.hlo_bytes_fused > rep.argument_bytes
    assert rep.fits and rep.num_devices == 1 and rep.mesh == "h100x1"
    assert rep.dominant in ("compute", "memory")
    assert rep.collective_bytes == rep.collective_s == 0.0
    dec = lowering.estimate_cell(
        "gemma3-12b", ShapeConfig("d", 40, 2, "decode", kv_len=40),
        cfg=_smoke("gemma3-12b"))
    assert dec.status == "ok", dec.error
    assert dec.useful_ratio > 0 and dec.output_bytes > 0


def test_data_dependent_and_skipped_cells():
    shape = ShapeConfig("p", 16, 2, "prefill")
    for impl in (None, "chunked", "einsum"):
        rep = lowering.estimate_cell("qwen2-vl-72b", shape,
                                     cfg=_smoke("qwen2-vl-72b"),
                                     attn_impl=impl)
        assert rep.status == "ok", (impl, rep.error)
    rep = lowering.estimate_cell("qwen2-vl-72b", shape,
                                 cfg=_smoke("qwen2-vl-72b"),
                                 attn_impl="plain")
    assert rep.status == "error" and "equal" in rep.error
    assert lowering.estimate_cell("yi-9b", "long_500k").status == "skipped"


def test_vlm_prefill_32k_is_costed_on_the_chunked_route():
    rep = lowering.estimate_cell("qwen2-vl-72b", "prefill_32k")
    assert rep.status == "ok", rep.error
    assert rep.hlo_flops > rep.model_flops_global > 0 and not rep.fits


@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "yi-9b"])
def test_smoke_chunked_prefill_flops_match_the_reference_hlo(arch):
    """At S = 1024 the reference's default prefill route maps two 512-query
    chunks (a ``while`` loop in its HLO); the port's default traces the
    same route."""
    B, S = 2, 1024
    ref_cfg = ref_smoke(ref_config(arch))
    ins = RM.input_specs(ref_cfg, RefShape("p", S, B, "prefill"))
    compiled = jax.jit(RM.make_prefill_step(ref_cfg)).lower(
        RM.abstract_params(ref_cfg), ins["batch"]).compile()
    want = analyze_hlo_text(compiled.as_text()).flops
    rep = lowering.estimate_cell(arch, ShapeConfig("p", S, B, "prefill"),
                                 cfg=_smoke(arch))
    assert rep.status == "ok", rep.error
    assert abs(rep.hlo_flops - want) <= REL_GAP * want


@pytest.mark.parametrize("S", [1024, 2048])
def test_chunked_prefill_saves_the_score_rows(S):
    """The same FLOPs on both routes.  Each route peaks in its last
    attention product, with the (rows, T) f32 scores, their softmax and
    the bias alive: S rows on the einsum route, one chunk's on the
    chunked route, which also holds its (B, S, H, hd) output, made up
    front, beside the chunk's (B, chunk, H, hd) product."""
    B, chunk = 2, 512
    cfg = _smoke("yi-9b")
    shape = ShapeConfig("p", S, B, "prefill")
    rep = {impl: lowering.estimate_cell("yi-9b", shape, cfg=cfg,
                                        attn_impl=impl)
           for impl in ("einsum", "chunked")}
    assert rep["einsum"].hlo_flops == rep["chunked"].hlo_flops
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    saved = (S - chunk) * S * (2 * B * H + 1) * 4 - B * chunk * H * hd * 4
    assert (rep["einsum"].bytes_per_device
            - rep["chunked"].bytes_per_device) == saved
    assert rep["einsum"].argument_bytes == rep["chunked"].argument_bytes


@pytest.mark.parametrize("mode,remat", [("prefill", "none"),
                                        ("train", "none"), ("train", "full")])
def test_chunk_loop_traced_in_part_counts_as_the_full_loop(monkeypatch, mode,
                                                           remat):
    """Four 512-query chunks a layer: the prefill's loop traced three
    chunks deep (with autograd, every chunk is traced) gives the FLOPs,
    bytes and peak of the loop run in full."""
    shape = ShapeConfig("c", 2048, 2, mode)
    train_cfg = lowering.TrainConfig(remat_policy=remat, grad_accum=2)
    counts = []
    for full in (False, True):
        if full:
            monkeypatch.setattr(cost, "steps",
                                lambda n, closed=False: iter(range(n)))
        step, args = lowering._build_step(_smoke("gemma3-12b"), shape,
                                          train_cfg, "chunked")
        grad = torch.enable_grad if mode == "train" else torch.no_grad
        with grad(), cost.Tally() as tally:
            tally.hold(args)
            step(*args)
        counts.append((tally.flops, tally.bytes, tally.peak))
    assert counts[0] == counts[1]


def test_dryrun_and_roofline_entry_points(tmp_path):
    out = tmp_path / "dryrun.json"
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "whisper-tiny", "--shape", "decode_32k", "--shape", "long_500k",
         "--out", str(out)], capture_output=True, text=True, timeout=300,
        cwd=ROOT, env=dict(os.environ, PYTHONPATH="src"))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "[PASS] whisper-tiny" in r.stdout and "h100x1" in r.stdout
    assert "[SKIP] whisper-tiny" in r.stdout
    recs = json.loads(out.read_text())
    assert [x["status"] for x in recs] == ["ok", "skipped"]
    assert roofline.main(["--dir", str(tmp_path)]) == 0
    table = (tmp_path / "roofline.md").read_text()
    assert "| whisper-tiny | decode_32k | h100x1 |" in table
    assert roofline.main(["--dir", str(tmp_path / "none")]) == 1


def test_dryrun_attn_impl_flag(tmp_path):
    """``--attn-impl einsum`` and ``chunked`` on one prefill cell: the
    same FLOPs, the chunked route's peak the lower."""
    recs = {}
    for impl in ("einsum", "chunked"):
        out = tmp_path / f"{impl}.json"
        r = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             "whisper-tiny", "--shape", "prefill_32k", "--attn-impl", impl,
             "--out", str(out)], capture_output=True, text=True,
            timeout=300, cwd=ROOT, env=dict(os.environ, PYTHONPATH="src"))
        assert r.returncode == 0, r.stderr[-2000:]
        assert "[PASS] whisper-tiny" in r.stdout
        [recs[impl]] = json.loads(out.read_text())
    assert recs["einsum"]["hlo_flops"] == recs["chunked"]["hlo_flops"]
    assert (recs["chunked"]["bytes_per_device"]
            < recs["einsum"]["bytes_per_device"])
