"""The port's multi-pod dry-run (``repro_torch.launch.lowering.lower_cell``
/ ``estimate_cell(mesh=...)``, ``launch.dryrun --multi-pod``) against the
reference's ``lower_cell`` and ``hlo_cost``.

* Every parameter, optimizer-state, batch and cache leaf of every arch x
  applicable shape x production mesh (``pod16x16``, ``pod2x16x16``) has
  the per-device shape of the reference's ``NamedSharding(AbstractMesh,
  spec).shard_shape`` under the cell's rules and overrides (equality),
  and rank 0's DTensors of a cell hold exactly those local shapes.
* At smoke size on a (2, 2) mesh against the reference's
  ``_build_lowerable(...).lower().compile()`` (a subprocess with 4 host
  devices, Auto axes): argument bytes equal up to the host scalars (the
  train step counter and the decode position, int32, 4 B each); the
  port / reference FLOPs-a-device ratio within 0.02 of the same ratio on
  a (1, 1) mesh; the FSDP weight gathers and the gradient reduction
  present with the bytes the spec trees imply; the train and prefill
  cells' collective bytes within 2x of the reference's.  The collective
  bytes are compared in float32: XLA's CPU backend runs a bf16 model's
  collectives in f32 (its dumps read f32[...] buffers), which doubles
  its bytes against the port's bf16 ones.  The decode cell's collectives
  are held to the online-softmax combine's bytes, counted by hand: its
  cache's sequence is split over the model axis, and the reference's
  rule comment asks for the combine, while XLA's CPU partitioner at
  this size moves the cache instead (all-gathers of it), so its bytes
  are the larger.
* A (1, 1) mesh gives the one-card estimate exactly; with no mesh every
  sharding helper is the identity; no process group is left after a
  cell, a failing one included; ``--multi-pod both`` prints both rows.
* The collective accounting: all-gather 1 x its result, all-reduce 2 x
  its buffer, reduce-scatter its operand, each counted once a call and
  multiplied through ``cost.steps``; rank 0's program run on local
  shards emits the collectives the ``meta`` trace counts.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402
from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs.base import TrainConfig as RefTrainConfig  # noqa: E402
from repro.distributed import sharding as rsh  # noqa: E402
from repro.launch import lowering as rlow  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.optim import cosine_schedule as ref_cosine  # noqa: E402
from repro.optim import make_optimizer as ref_make_optimizer  # noqa: E402
from repro_torch.configs import SHAPES, get_config, smoke_variant  # noqa: E402
from repro_torch.configs.base import ShapeConfig, TrainConfig  # noqa: E402
from repro_torch.distributed import sharding as psh  # noqa: E402
from repro_torch.launch import cost, lowering  # noqa: E402
from repro_torch.launch.mesh import (device_mesh, make_debug_mesh,  # noqa: E402
                                     make_production_mesh)
from repro_torch.models import model as PM  # noqa: E402
from repro_torch.optim import cosine_schedule, make_optimizer  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLOPS_RATIO_TOL = 0.02      # (2, 2) ratio against the (1, 1) ratio
COLLECTIVE_FACTOR = 2.0     # total collective bytes against the reference
HOST_SCALAR_BYTES = 4       # the int32 step counter / decode position


# --------------------------------------------------------------------------
# (a) per-device shapes on the production meshes
# --------------------------------------------------------------------------
def _pairs(spec, val) -> list:
    """(logical axes, global shape) of each leaf of a spec tree and the
    tree of arrays / tensors it describes."""
    if psh._is_spec_leaf(spec):
        return [(spec, tuple(val.shape))]
    if isinstance(spec, dict):
        return [p for k in sorted(spec) for p in _pairs(spec[k], val[k])]
    return [p for s, v in zip(spec, val) for p in _pairs(s, v)]


def _ref_trees(arch, shape_name):
    cfg, shape = ref_config(arch), REF_SHAPES[shape_name]
    ins = RM.input_specs(cfg, shape)
    bspec = RM.batch_specs(cfg, shape)
    if shape.mode == "train":
        tc = RefTrainConfig(**rlow.CELL_TRAIN_OVERRIDES.get(arch, {}))
        opt = ref_make_optimizer(
            tc.optimizer, ref_cosine(tc.learning_rate, tc.warmup_steps,
                                     tc.total_steps),
            moments_dtype=tc.moments_dtype)
        return [(RM.train_state_specs(cfg, opt),
                 RM.abstract_train_state(cfg, opt)),
                (bspec["batch"], ins["batch"])]
    trees = [(RM.param_specs(cfg), RM.abstract_params(cfg))]
    if shape.mode == "prefill":
        return trees + [(bspec["batch"], ins["batch"])]
    return trees + [(bspec[k], ins[k]) for k in bspec]


def _port_trees(arch, shape_name):
    cfg, shape = get_config(arch), SHAPES[shape_name]
    ins = PM.input_specs(cfg, shape)
    bspec = PM.batch_specs(cfg, shape)
    if shape.mode == "train":
        tc = TrainConfig(**lowering.CELL_TRAIN_OVERRIDES.get(arch, {}))
        opt = make_optimizer(
            tc.optimizer, cosine_schedule(tc.learning_rate, tc.warmup_steps,
                                          tc.total_steps),
            moments_dtype=tc.moments_dtype)
        return [(PM.train_state_specs(cfg, opt),
                 PM.abstract_train_state(cfg, opt)),
                (bspec["batch"], ins["batch"])]
    trees = [(PM.param_specs(cfg), PM.abstract_params(cfg))]
    if shape.mode == "prefill":
        return trees + [(bspec["batch"], ins["batch"])]
    return trees + [(bspec[k], ins[k]) for k in bspec]


def _cells():
    return [(arch, shape) for arch in ARCH_IDS for shape in SHAPES
            if lowering.shape_applicable(get_config(arch), shape)
            and not lowering.cell_is_skipped(arch, shape)]


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shard_shapes_equal_the_reference(arch, multi_pod):
    mesh = make_production_mesh(multi_pod=multi_pod)
    amesh = AbstractMesh(mesh.shape, mesh.axis_names)
    ref_mesh = type("M", (), {"axis_names": mesh.axis_names,
                              "devices": np.empty(mesh.shape, np.int8)})
    n = 0
    for _, shape in [c for c in _cells() if c[0] == arch]:
        over = lowering.CELL_RULES_OVERRIDES.get((arch, shape), {})
        rules_r = dict(rsh.rules_for(ref_config(arch), REF_SHAPES[shape],
                                     ref_mesh), **over)
        rules_p = dict(psh.rules_for(get_config(arch), SHAPES[shape], mesh),
                       **over)
        with rsh.use_mesh(ref_mesh, rules_r):
            want = [NamedSharding(amesh, P(*rsh.logical_spec(*s)))
                    .shard_shape(g) for t in _ref_trees(arch, shape)
                    for s, g in _pairs(*t)]
        with psh.use_mesh(mesh, rules_p):
            got = [psh.shard_shape(g, psh.logical_spec(*s), mesh)
                   for t in _port_trees(arch, shape) for s, g in _pairs(*t)]
        assert got == want, (arch, shape)
        n += len(got)
    assert n > 0


def test_rank0_dtensors_hold_the_shard_shapes():
    """qwen2-vl-72b train_4k on pod16x16 (cut to 2 layers): every tensor
    argument of rank 0's step is a DTensor of its global shape whose local
    shard has the shape ``shard_shape`` gives."""
    mesh = make_production_mesh()
    arch, shape = "qwen2-vl-72b", SHAPES["train_4k"]
    cfg = dataclasses.replace(get_config(arch), num_layers=2)
    tc = TrainConfig(grad_accum=0, **lowering.CELL_TRAIN_OVERRIDES[arch])
    with lowering.cell_program(arch, shape, cfg=cfg, mesh=mesh) as (
            _, args, notes):
        rules = dict(psh.rules_for(cfg, shape, mesh),
                     **lowering.CELL_RULES_OVERRIDES[(arch, "train_4k")])
        specs = lowering.build_step(cfg, shape, tc, None, mesh, rules)[2]
        pairs = _leaf_pairs(specs, args)
        for s, leaf in pairs:
            assert psh.is_distributed(leaf)
            assert tuple(leaf.to_local().shape) == psh.shard_shape(
                tuple(leaf.shape), psh.logical_spec(*s), mesh)
        assert len(pairs) == len([t for t in tree_leaves(args)
                                  if torch.is_tensor(t)]) > 10
    assert notes == ["rules overrides: {'act_seq': 'model'}",
                     f"train overrides: "
                     f"{lowering.CELL_TRAIN_OVERRIDES[arch]}"]
    assert not torch.distributed.is_initialized()


def _leaf_pairs(spec, val) -> list:
    """(logical axes, tensor) of each tensor leaf of a tree."""
    if psh._is_spec_leaf(spec):
        return [(spec, val)] if torch.is_tensor(val) else []
    if isinstance(spec, dict):
        return [p for k in sorted(spec) for p in _leaf_pairs(spec[k],
                                                             val[k])]
    return [p for s, v in zip(spec, val) for p in _leaf_pairs(s, v)]


# --------------------------------------------------------------------------
# (b) smoke size on a (2, 2) mesh against the reference's compile
# --------------------------------------------------------------------------
SMOKE_CELLS = {
    "yi-9b/train": ("yi-9b", ("t", 64, 8, "train")),
    "gemma3-12b/prefill": ("gemma3-12b", ("p", 64, 8, "prefill")),
    "yi-9b/decode": ("yi-9b", ("d", 64, 8, "decode", 64)),
}

_REF_SCRIPT = textwrap.dedent("""
    import os
    os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=4'
    import dataclasses, json, sys
    import jax
    from jax.sharding import AxisType
    from repro.configs import get_config, smoke_variant
    from repro.configs.base import ShapeConfig, TrainConfig
    from repro.distributed import sharding as sh
    from repro.launch.lowering import _build_lowerable
    from repro.launch import hlo_cost

    cells, dtype = json.loads(sys.argv[1]), sys.argv[2]
    out = {}
    for name, (arch, dims) in cells.items():
        cfg = dataclasses.replace(smoke_variant(get_config(arch)),
                                  dtype=dtype)
        shape = ShapeConfig(*dims)
        for ms in ((1, 1), (2, 2)):
            mesh = jax.make_mesh(ms, ('data', 'model'),
                                 devices=jax.devices()[:ms[0] * ms[1]],
                                 axis_types=(AxisType.Auto, AxisType.Auto))
            rules = sh.rules_for(cfg, shape, mesh)
            with sh.use_mesh(mesh, rules):
                fn, args = _build_lowerable(
                    cfg, shape, mesh, rules, attn_impl=None,
                    train_cfg=TrainConfig(grad_accum=2))
                compiled = fn.lower(*args).compile()
            mem = compiled.memory_analysis()
            c = hlo_cost.analyze_hlo_text(compiled.as_text())
            out[f"{name}/{ms[0]}x{ms[1]}"] = dict(
                argument_bytes=mem.argument_size_in_bytes, flops=c.flops,
                collective_bytes=c.collective_bytes,
                counts=dict(c.collective_counts))
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def reference_smoke():
    """The reference's smoke lowerings, {dtype: {cell/mesh: numbers}}."""
    out = {}
    for dtype in ("bfloat16", "float32"):
        r = subprocess.run(
            [sys.executable, "-c", _REF_SCRIPT, json.dumps(SMOKE_CELLS),
             dtype], capture_output=True, text=True, timeout=600,
            env={"PYTHONPATH": os.path.join(ROOT, "src"),
                 "PATH": "/usr/bin:/bin"})
        assert r.returncode == 0, r.stderr[-2000:]
        out[dtype] = json.loads(r.stdout.strip().splitlines()[-1])
    return out


def _port_smoke(name, dtype, mesh_shape, log=None):
    arch, dims = SMOKE_CELLS[name]
    cfg = dataclasses.replace(smoke_variant(get_config(arch)), dtype=dtype)
    rep = lowering.estimate_cell(arch, ShapeConfig(*dims), cfg=cfg,
                                 mesh=make_debug_mesh(mesh_shape),
                                 train_cfg=TrainConfig(grad_accum=2))
    assert rep.status == "ok", rep.error
    return rep


@pytest.mark.parametrize("name", list(SMOKE_CELLS))
def test_smoke_arguments_and_flops_against_the_reference(reference_smoke,
                                                         name):
    ref = reference_smoke["bfloat16"]
    ratios = {}
    for ms in ((1, 1), (2, 2)):
        rep = _port_smoke(name, "bfloat16", ms)
        r = ref[f"{name}/{ms[0]}x{ms[1]}"]
        host = 0 if SMOKE_CELLS[name][1][3] == "prefill" else \
            HOST_SCALAR_BYTES
        assert rep.argument_bytes + host == r["argument_bytes"], (name, ms)
        ratios[ms] = rep.hlo_flops / r["flops"]
    gap = ratios[(2, 2)] - ratios[(1, 1)]
    assert abs(gap) <= FLOPS_RATIO_TOL, (name, ratios)


@pytest.mark.parametrize("name", ["yi-9b/train", "gemma3-12b/prefill"])
def test_smoke_collective_bytes_within_2x_of_the_reference(reference_smoke,
                                                           name):
    ref = reference_smoke["float32"][f"{name}/2x2"]
    rep = _port_smoke(name, "float32", (2, 2))
    ratio = rep.collective_bytes / ref["collective_bytes"]
    assert 1 / COLLECTIVE_FACTOR <= ratio <= COLLECTIVE_FACTOR, (
        f"{name}: port {rep.collective_bytes:.0f} B "
        f"{rep.collective_counts}, reference {ref['collective_bytes']:.0f} "
        f"B {ref['counts']}, ratio {ratio:.4f}")


def _logged_collectives(monkeypatch):
    log = []
    real = cost.collective

    def logged(func, args, kwargs, out):
        got = real(func, args, kwargs, out)
        if got is not None:
            log.append(got)
        return got
    monkeypatch.setattr(cost, "collective", logged)
    return log


def test_fsdp_gathers_and_gradient_reduction_have_the_spec_bytes(
        monkeypatch):
    """yi-9b smoke train on (2, 2), bf16: each layer weight split over
    ``data`` (FSDP) is all-gathered to its model-split shape and its
    gradient reduce-scattered from that shape; each replicated weight's
    gradient is all-reduced (2 x its bytes)."""
    log = _logged_collectives(monkeypatch)
    _port_smoke("yi-9b/train", "bfloat16", (2, 2))
    cfg = dataclasses.replace(smoke_variant(get_config("yi-9b")),
                              dtype="bfloat16")
    mesh = make_debug_mesh((2, 2))
    rules = psh.rules_for(cfg, ShapeConfig("t", 64, 8, "train"), mesh)
    layer = PM.param_specs(cfg)["layers"]
    shapes = {k: tuple(v.shape[1:]) for k, v in
              PM.abstract_params(cfg)["layers"].items()}
    gathers = {b for k, b in log if k == "all-gather"}
    scatters = {b for k, b in log if k == "reduce-scatter"}
    reduces = {b for k, b in log if k == "all-reduce"}
    with psh.use_mesh(mesh, dict(rules, w_data=None)):
        for name, spec in layer.items():
            full = psh.shard_shape(shapes[name], psh.logical_spec(*spec[1:]),
                                   mesh)
            nbytes = int(np.prod(full)) * 2
            if "w_data" in spec:
                assert nbytes in gathers, (name, nbytes, sorted(gathers))
                assert nbytes in scatters, (name, nbytes, sorted(scatters))
            else:
                assert 2 * nbytes in reduces, (name, nbytes, sorted(reduces))


def test_decode_collectives_are_the_online_softmax_combine(reference_smoke):
    """yi-9b smoke decode on (2, 2), f32: the embedding's vocab-parallel
    all-reduce, then per layer the combine's max, denominator and values
    all-reduced across the cache's sequence shards, the queries gathered
    over the heads, the row-parallel attention and MLP outputs
    all-reduced; below the reference's bytes, which move the cache."""
    rep = _port_smoke("yi-9b/decode", "float32", (2, 2))
    cfg = smoke_variant(get_config("yi-9b"))
    B, H, hd, d, f32 = 8 // 2, cfg.num_heads, cfg.resolved_head_dim, \
        cfg.d_model, 4
    layer = (2 * B * H * f32 + 2 * B * H * f32 + 2 * B * H * hd * f32
             + B * H * hd * f32 + 2 * 2 * B * d * f32)
    want = 2 * B * d * f32 + cfg.num_layers * layer
    assert rep.collective_bytes == want, (rep.collective_bytes, want)
    assert rep.collective_counts == {"all-reduce": 1 + 5 * cfg.num_layers,
                                     "all-gather": cfg.num_layers}
    ref = reference_smoke["float32"]["yi-9b/decode/2x2"]
    assert rep.collective_bytes < ref["collective_bytes"], ref


# --------------------------------------------------------------------------
# (c)-(f)
# --------------------------------------------------------------------------
FIELDS = ("argument_bytes", "output_bytes", "bytes_per_device", "temp_bytes",
          "hlo_flops", "xla_flops_raw", "hlo_bytes", "hlo_bytes_fused",
          "collective_bytes", "compute_s", "memory_s", "collective_s",
          "useful_ratio", "fits", "dominant", "collective_counts")


@pytest.mark.parametrize("name", list(SMOKE_CELLS))
def test_one_by_one_mesh_is_the_one_card_estimate(name):
    arch, dims = SMOKE_CELLS[name]
    cfg = dataclasses.replace(smoke_variant(get_config(arch)),
                              dtype="bfloat16")
    kw = dict(cfg=cfg, train_cfg=TrainConfig(grad_accum=2))
    card = lowering.estimate_cell(arch, ShapeConfig(*dims), **kw)
    mesh = lowering.estimate_cell(arch, ShapeConfig(*dims),
                                  mesh=make_debug_mesh((1, 1)), **kw)
    assert card.status == mesh.status == "ok"
    assert (card.mesh, mesh.mesh) == ("h100x1", "mesh1x1")
    for f in FIELDS:
        assert getattr(card, f) == getattr(mesh, f), f


def test_sharding_helpers_are_the_identity_without_a_mesh():
    x = torch.arange(12.0).reshape(3, 4)
    w = torch.arange(8.0).reshape(4, 2)
    assert psh.active_device_mesh() is None
    assert psh.constraint(x, "batch", None) is x
    assert psh.gather_weights({"w": w})["w"] is w
    assert psh.all_reduce(x, "sum", "vocab") is x
    assert psh.all_gather(x, 1, "w_data") is x
    assert not psh.splits("vocab") and psh.mesh_coordinate("heads") == (0, 1)
    assert psh.local_map(lambda a: a * 2, (("batch", None),),
                         ("batch", None))(x).equal(x * 2)
    assert psh.einsum("ij,jk->ik", x, w).equal(torch.einsum("ij,jk->ik", x,
                                                            w))
    assert not psh.is_distributed(x)


def test_no_process_group_is_left_after_a_cell():
    cfg = smoke_variant(get_config("whisper-tiny"))
    shape = ShapeConfig("d", 32, 4, "decode", 32)
    ok = lowering.estimate_cell("whisper-tiny", shape, cfg=cfg,
                                mesh=make_debug_mesh((2, 2)))
    assert ok.status == "ok" and not torch.distributed.is_initialized()
    bad = lowering.estimate_cell("whisper-tiny", ShapeConfig("t", 32, 4,
                                                             "train"),
                                 cfg=cfg, attn_impl="nowhere",
                                 mesh=make_debug_mesh((2, 2)))
    assert bad.status == "error" and "nowhere" in bad.error
    assert not torch.distributed.is_initialized()
    with device_mesh(make_debug_mesh((2, 2))) as dm:
        assert dm.size() == 4 and torch.distributed.get_world_size() == 4
        with pytest.raises(RuntimeError):
            with device_mesh(make_debug_mesh((2, 2))):
                pass
    assert not torch.distributed.is_initialized()


def test_dryrun_multi_pod_both_prints_both_meshes(tmp_path):
    out = tmp_path / "dryrun_mesh.json"
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "whisper-tiny", "--shape", "decode_32k", "--multi-pod", "both",
         "--out", str(out)], capture_output=True, text=True, timeout=300,
        cwd=ROOT, env=dict(os.environ, PYTHONPATH="src"))
    assert r.returncode == 0, r.stderr[-2000:]
    rows = [ln for ln in r.stdout.splitlines() if ln.startswith("[PASS]")]
    assert len(rows) == 2, r.stdout
    assert "pod16x16" in rows[0] and "pod2x16x16" in rows[1]
    recs = json.loads(out.read_text())
    assert [x["mesh"] for x in recs] == ["pod16x16", "pod2x16x16"]
    assert [x["num_devices"] for x in recs] == [256, 512]
    assert all(x["collective_bytes"] > 0 and x["collective_s"] > 0
               for x in recs)


def test_production_train_cell_reduces_its_gradients():
    """whisper-tiny train_4k on pod2x16x16 (one encoder and one decoder
    layer): ok, 512 devices, gradients reduce-scattered (FSDP) and
    all-reduced, the collective term from the network constant, the
    useful ratio over all devices."""
    cfg = dataclasses.replace(get_config("whisper-tiny"), num_layers=1,
                              encoder_layers=1)
    rep = lowering.estimate_cell("whisper-tiny", "train_4k", cfg=cfg,
                                 mesh=make_production_mesh(multi_pod=True))
    assert rep.status == "ok", rep.error
    assert (rep.mesh, rep.num_devices) == ("pod2x16x16", 512)
    assert rep.collective_counts["reduce-scatter"] > 0
    assert rep.collective_counts["all-reduce"] > 0
    assert rep.collective_s == rep.collective_bytes / lowering.NET_BW
    assert rep.useful_ratio == pytest.approx(
        rep.model_flops_global / (rep.hlo_flops * 512), rel=1e-12)
    assert rep.fits and rep.bytes_per_device < lowering.HBM_BYTES


# --------------------------------------------------------------------------
# the collective accounting
# --------------------------------------------------------------------------
def test_collective_bytes_follow_the_reference_rule():
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = make_debug_mesh((2, 2))
    with device_mesh(mesh) as dm:
        def dt(placements, local=(8, 6)):
            return DTensor.from_local(
                torch.empty(local, device="meta"), dm, placements,
                run_check=False)
        with torch.no_grad(), cost.Tally() as tally:
            dt([Shard(0), Replicate()]).redistribute(
                dm, [Replicate(), Replicate()])            # all-gather
        assert tally.collective_counts == {"all-gather": 1}
        assert tally.collective_bytes == 16 * 6 * 4
        with torch.no_grad(), cost.Tally() as tally:
            dt([Partial(), Replicate()]).redistribute(
                dm, [Replicate(), Replicate()])            # all-reduce
        assert tally.collective_counts == {"all-reduce": 1}
        assert tally.collective_bytes == 2 * 8 * 6 * 4
        with torch.no_grad(), cost.Tally() as tally:
            dt([Partial(), Replicate()]).redistribute(
                dm, [Shard(0), Replicate()])               # reduce-scatter
        assert tally.collective_counts == {"reduce-scatter": 1}
        assert tally.collective_bytes == 8 * 6 * 4
        x = dt([Partial(), Replicate()])
        with torch.no_grad(), cost.Tally() as tally:
            for _ in cost.steps(7):
                x.redistribute(dm, [Replicate(), Replicate()])
        assert tally.collective_counts == {"all-reduce": 7}
        assert tally.collective_bytes == 7 * 2 * 8 * 6 * 4
    assert not torch.distributed.is_initialized()


def test_rank0_run_emits_the_traced_collectives():
    """A 2-layer smoke qwen2-vl-72b train step (the reference's overrides:
    sequence-parallel activations, bf16 moments and accumulation) on a
    (2, 2) CPU mesh: the collectives rank 0's program emits on seeded
    local shards, by kind and bytes, equal the ``meta`` trace's (what
    ``chip_smoke.py`` holds on the card)."""
    cfg = dataclasses.replace(smoke_variant(get_config("qwen2-vl-72b")),
                              dtype="bfloat16", num_layers=2)
    shape = ShapeConfig("train_4k", 64, 8, "train")
    mesh = make_debug_mesh((2, 2))
    gen = torch.Generator().manual_seed(0)

    def make(dims, dtype):
        if dtype.is_floating_point:
            return (torch.randn(dims, generator=gen) * 0.02).to(dtype)
        return torch.randint(0, 64, dims, generator=gen, dtype=dtype)

    with lowering.cell_program("qwen2-vl-72b", shape, cfg=cfg, mesh=mesh,
                               device_type="cpu") as (step, args, _):
        with torch.enable_grad(), cost.Tally() as tally:
            tally.hold(args)
            step(*args)
    with lowering.cell_program("qwen2-vl-72b", shape, cfg=cfg, mesh=mesh,
                               make=make, device_type="cpu") as (step, args,
                                                                 _):
        with torch.enable_grad(), cost.Collectives() as run:
            out = step(*args)
        embed = out[0].params["embed"]
        assert tuple(embed.to_local().shape) == psh.shard_shape(
            tuple(embed.shape), psh.logical_spec("vocab", "embed_d"), mesh)
    assert run.counts == tally.collective_counts
    assert run.bytes == tally.collective_bytes
    assert not torch.distributed.is_initialized()
