"""Cell estimates: (architecture x input shape x mesh) -> FLOPs, bytes,
collective bytes, peak memory and roofline terms per device (the
reference's ``repro.launch.lowering``, which lowers a cell on a TPU mesh
and costs its HLO).

Per cell, :func:`estimate_cell` runs the cell's step (a train step, a
prefill, or one decode step) through the port's models on the ``meta``
device, under a :class:`repro_torch.launch.cost.Tally`:

  * the step's FLOPs, loop-aware (``hlo_flops``), and the same count with
    every repeated loop counted once (``xla_flops_raw``);
  * each op's operand and result bytes (``hlo_bytes``, an upper bound)
    and the step's least traffic (``hlo_bytes_fused``: its arguments
    read once and its new outputs written once);
  * the peak of the bytes alive at once, arguments included
    (``bytes_per_device``), and whether it ``fits`` the card;
  * the collectives' bytes and counts by kind (``collective_bytes``,
    ``collective_counts``);
  * the roofline terms at the H100 SXM's published peaks and the
    dominant one, and ``model_flops`` (6·N·D) with the useful ratio over
    all devices.

On one card (no ``mesh``, mesh name ``h100x1``) nothing is laid out and
no collective runs.  On a mesh (:func:`lower_cell`, the production
``pod16x16`` and ``pod2x16x16`` of the reference's dry-run, or any
:class:`~repro_torch.distributed.sharding.Mesh`) the step runs as rank
0's program: every argument is a DTensor laid out by the port's spec
trees under ``rules_for`` and :data:`CELL_RULES_OVERRIDES`, on a
``DeviceMesh`` over a ``"fake"`` process group
(:func:`repro_torch.launch.mesh.device_mesh`), so the tally counts one
device's local ops and the collectives DTensor emits for the models'
sharding constraints and the ops whose operands are laid out apart.
Every number is a device's; the collective term divides by
:data:`NET_BW`.

Attention takes the route the reference's dry-run lowers
(``_build_lowerable`` in ``repro.launch.lowering``), never a kernel:
``attn_impl`` where given, else ``"chunked"`` for a prefill (the einsum
attention 512 queries at a time, so one chunk's scores are alive at
once) and ``"einsum"`` for a train step (full S x T scores, which its
backward keeps); a decode step attends over its cache.  No kernel
wrapper is reached, and every route masks by the positions without
reading them.  A step that reads a value (the MoE dispatch's counts)
cannot run on ``meta``: its cell reports ``status="error"`` with the
reason, and the sweep goes on.  Nothing is placed on any device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Optional, Union

import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.distributed import sharding as sh
from repro_torch.launch import cost
from repro_torch.launch.mesh import (device_mesh, make_production_mesh,
                                     mesh_axis_sizes, mesh_name)
from repro_torch.models import model as M
from repro_torch.optim import TrainState, cosine_schedule, make_optimizer
from repro_torch.tree import tree_leaves

# NVIDIA's published H100 SXM figures: dense bf16 tensor-core FLOP/s, HBM3
# bytes/s and the card's HBM (80 GB).  Published constants, not
# measurements.
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
HBM_BYTES = 80e9
#: a GPU's network bytes/s in one direction: a DGX H100 node has eight
#: 400 Gb/s ConnectX-7 ports for its 8 GPUs.  A 256-GPU mesh is 32 such
#: nodes and a 16-wide axis spans two of them, so every mesh axis crosses
#: the network (NVLink, 450 GB/s a direction, joins only the 8 GPUs of a
#: node).  The reference divides by a TPU v5e ICI link's 50 GB/s.
NET_BW = 8 * 400e9 / 8 / 8
NVLINK_BW = 450e9
MESH_NAME = "h100x1"
#: tokens a microbatch of an auto-sized (``grad_accum=0``) train step
#: holds on its device, the reference's rule
MICRO_TOKENS = 4096

LONG_CONTEXT_OK = {"xlstm-350m", "hymba-1.5b", "gemma3-12b"}

# Per-cell training overrides (the reference's): >=70B-class models take
# bf16 optimizer moments and bf16 grad accumulation, qwen3-moe Adafactor
# and the grouped MoE dispatch.
CELL_TRAIN_OVERRIDES: dict[str, dict] = {
    "qwen3-moe-235b-a22b": dict(optimizer="adafactor",
                                accum_dtype="bfloat16",
                                moe_impl="ragged"),
    "qwen2-vl-72b": dict(moments_dtype="bfloat16",
                         accum_dtype="bfloat16"),
    "granite-34b": dict(moments_dtype="bfloat16"),
}

# Per-cell sharding-rule overrides (the reference's, for a mesh's rules:
# sequence-parallel activations in training, serve-time FSDP for the
# >=34B models), applied when the caller passes none.  On one card
# nothing is placed, so the one-card estimate reads none.
CELL_RULES_OVERRIDES: dict[tuple[str, str], dict] = {
    ("granite-34b", "train_4k"): {"act_seq": "model"},
    ("qwen2-vl-72b", "train_4k"): {"act_seq": "model"},
    ("qwen3-moe-235b-a22b", "train_4k"): {"act_seq": "model"},
    ("granite-34b", "prefill_32k"): {"w_data": "data", "embed_d": "data"},
    ("qwen2-vl-72b", "prefill_32k"): {"w_data": "data", "embed_d": "data"},
    ("qwen2-vl-72b", "decode_32k"): {"w_data": "data", "embed_d": "data"},
    ("qwen3-moe-235b-a22b", "prefill_32k"): {"w_data": "data",
                                             "embed_d": "data"},
    ("qwen3-moe-235b-a22b", "decode_32k"): {"w_data": "data",
                                            "embed_d": "data"},
}


def cell_is_skipped(arch: str, shape_name: str) -> Optional[str]:
    if shape_name == "long_500k" and arch not in LONG_CONTEXT_OK:
        return ("pure full-attention arch: 500k decode cache excluded "
                "(DESIGN.md §Arch-applicability)")
    return None


def shape_applicable(cfg: ModelConfig, shape_name: str) -> bool:
    if not cfg.has_decoder and SHAPES[shape_name].mode == "decode":
        return False
    return True


@dataclasses.dataclass
class CellReport:
    arch: str
    shape: str
    mesh: str
    status: str = "ok"
    error: str = ""
    # memory: the traced step's live bytes
    bytes_per_device: float = 0.0   # peak, arguments included
    argument_bytes: float = 0.0
    temp_bytes: float = 0.0         # the peak's excess over the arguments
    output_bytes: float = 0.0       # the step's new outputs
    # loop-aware costs of the traced ops
    hlo_flops: float = 0.0
    hlo_bytes: float = 0.0          # per-op operands + results (upper bound)
    hlo_bytes_fused: float = 0.0    # least traffic (memory term)
    # the collectives a device emits (0 on one card)
    collective_bytes: float = 0.0
    collective_counts: dict = dataclasses.field(default_factory=dict)
    xla_flops_raw: float = 0.0      # each repeated loop's body counted once
    # roofline
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    dominant: str = ""
    model_flops_global: float = 0.0
    useful_ratio: float = 0.0
    compile_seconds: float = 0.0    # the trace's wall time
    num_devices: int = 0
    notes: str = ""
    fits: bool = False              # bytes_per_device <= the card's HBM

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Global useful model FLOPs for this entry point (6ND convention)."""
    n = cfg.active_param_count()
    if shape.mode == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.mode == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # decode: one token


def auto_grad_accum(shape: ShapeConfig, mesh: Optional[sh.Mesh] = None,
                    rules: Optional[dict] = None) -> int:
    """Microbatches of a ``grad_accum=0`` train step: about MICRO_TOKENS
    tokens a device each, the reference's rule, with the batch split
    over the mesh axes its ``"batch"`` rule names (the whole batch on one
    card)."""
    ways = 1
    if mesh is not None:
        sizes = mesh_axis_sizes(mesh)
        t = rules.get("batch")
        for nm in (t if isinstance(t, tuple) else (t,)):
            ways *= sizes.get(nm, 1) if nm else 1
    b = max(1, shape.global_batch // ways)
    return max(1, min(b, b * shape.seq_len // MICRO_TOKENS))


def _build_step(cfg: ModelConfig, shape: ShapeConfig,
                train_cfg: TrainConfig, attn_impl: Optional[str] = None):
    """(step, args): the cell's step on one card and its ``meta``
    arguments, its attention by ``attn_impl`` (default: the reference's,
    ``"einsum"`` to train, ``"chunked"`` to prefill)."""
    return build_step(cfg, shape, train_cfg, attn_impl)[:2]


def build_step(cfg: ModelConfig, shape: ShapeConfig, train_cfg: TrainConfig,
               attn_impl: Optional[str] = None,
               mesh: Optional[sh.Mesh] = None, rules: Optional[dict] = None,
               gen: Optional[torch.Generator] = None,
               device: Optional[torch.device] = None):
    """(step, args, specs): the cell's step, its arguments and their
    logical-axis trees (``sharding.shard_tree`` lays them out on a device
    mesh); a ``grad_accum=0`` train step's microbatches sized for
    ``mesh`` under ``rules``.  The arguments are ``meta`` stand-ins, or
    with ``gen`` values drawn from it on ``device`` (:func:`_draw`)."""
    ins = M.input_specs(cfg, shape)
    bspec = M.batch_specs(cfg, shape)
    if gen is not None:
        ins = _draw(ins, cfg, gen, device)
    init = ((lambda: M.init(cfg, gen, device)) if gen is not None
            else lambda: M.abstract_params(cfg))
    if shape.mode == "train":
        if train_cfg.grad_accum == 0:
            train_cfg = dataclasses.replace(
                train_cfg, grad_accum=auto_grad_accum(shape, mesh, rules))
        opt = make_optimizer(
            train_cfg.optimizer,
            cosine_schedule(train_cfg.learning_rate, train_cfg.warmup_steps,
                            train_cfg.total_steps),
            weight_decay=train_cfg.weight_decay,
            grad_clip=train_cfg.grad_clip,
            moments_dtype=train_cfg.moments_dtype)
        # The schedule reads the step counter on the host: a number here.
        params = init()
        state = TrainState(0, params, opt.init(params))
        step = M.make_train_step(cfg, opt, train_cfg,
                                 attn_impl=attn_impl or "einsum")
        return (step, (state, ins["batch"]),
                (M.train_state_specs(cfg, opt), bspec["batch"]))
    params = init()
    pspec = M.param_specs(cfg)
    if shape.mode == "prefill":
        return (M.make_prefill_step(cfg, attn_impl=attn_impl or "chunked"),
                (params, ins["batch"]), (pspec, bspec["batch"]))
    # decode: one step at the cache's last slot (its position is a host
    # number on the port)
    cache = dict(ins["cache"], pos=(shape.kv_len or shape.seq_len) - 1)
    decode = M.make_decode_step(cfg)
    args = (params, cache, ins["tokens"])
    specs = (pspec, bspec["cache"], bspec["tokens"])
    if cfg.mrope:
        args += (ins["positions"],)
        specs += (bspec["positions"],)
    return decode, args, specs


def _draw(tree, cfg: ModelConfig, gen: torch.Generator,
          device: Optional[torch.device], key: str = ""):
    """``meta`` model inputs (:func:`repro_torch.models.model.input_specs`)
    replaced by values drawn from ``gen`` on ``device``, in tree order:
    tokens and labels below the vocabulary, M-RoPE positions counting up
    the sequence, everything floating (caches, frames, vision embeddings)
    N(0, 1) in its dtype."""
    if isinstance(tree, dict):
        return {k: _draw(v, cfg, gen, device, k) for k, v in tree.items()}
    if not isinstance(tree, torch.Tensor):
        return tree
    dims = tuple(tree.shape)
    if tree.is_floating_point():
        return torch.randn(dims, generator=gen, device=device).to(tree.dtype)
    if key == "positions":
        return torch.arange(dims[-1], dtype=tree.dtype,
                            device=device).expand(dims).contiguous()
    return torch.randint(0, cfg.vocab_size, dims, generator=gen,
                         dtype=tree.dtype, device=device)


def _storages(tree) -> dict[int, int]:
    """{storage id: bytes} of the tensors of ``tree`` (a DTensor's local
    shard)."""
    out = {}
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            st = sh.local(t).untyped_storage()
            out[id(st)] = st.nbytes()
    return out


def _cell_settings(arch: str, cfg: ModelConfig, shape: ShapeConfig,
                   mesh: Optional[sh.Mesh], train_cfg: Optional[TrainConfig],
                   rules_override: Optional[dict]
                   ) -> tuple[Optional[dict], TrainConfig, list[str]]:
    """(rules, train config, notes) of a cell: on a mesh the rules for it
    with ``rules_override`` (default :data:`CELL_RULES_OVERRIDES`' entry)
    applied, the training config ``train_cfg`` (default
    :data:`CELL_TRAIN_OVERRIDES`' with ``grad_accum=0``), and a note of
    each override taken, as the reference's ``lower_cell`` notes them."""
    notes, rules = [], None
    if mesh is not None:
        rules = sh.rules_for(cfg, shape, mesh)
        if rules_override is None:
            rules_override = CELL_RULES_OVERRIDES.get((arch, shape.name))
        if rules_override:
            rules.update(rules_override)
            notes.append(f"rules overrides: {rules_override}")
    if train_cfg is None:
        over = CELL_TRAIN_OVERRIDES.get(arch, {})
        train_cfg = TrainConfig(grad_accum=0, **over)
        if over and shape.mode == "train":
            notes.append(f"train overrides: {over}")
    return rules, train_cfg, notes


@contextlib.contextmanager
def cell_program(arch: str, shape: Union[str, ShapeConfig], *,
                 mesh: Optional[sh.Mesh] = None,
                 cfg: Optional[ModelConfig] = None,
                 train_cfg: Optional[TrainConfig] = None,
                 attn_impl: Optional[str] = None,
                 rules_override: Optional[dict] = None, make=None,
                 device_type: str = "cuda", backend: str = "fake",
                 seed: Optional[int] = None):
    """``with cell_program(...) as (step, args, notes):`` the cell's step
    and its arguments, a mesh's laid out on a ``DeviceMesh`` of
    ``device_type`` devices (a ``"cpu"`` mesh takes local shards on the
    CPU) with its rules, implicit replication and DTensor active inside
    the block.

    ``backend="fake"`` (the trace): the arguments are rank 0's shards on
    a fake process group (destroyed on exit), each local shard made by
    ``make(shape, dtype)`` (default: ``meta``, for a trace; a seeded
    tensor on the card runs rank 0's program for real).

    ``seed``: the global arguments drawn from it (:func:`_draw`, the
    model's and the optimizer's own init) on the CPU or the current card,
    the same on every rank.  With no mesh the step is the unsharded one;
    with ``backend="gloo"`` or ``"nccl"`` each rank of the group it
    joined (:mod:`repro_torch.distributed.ranks`) keeps its shards of
    them and runs its own program, whose collectives move data, so the
    ``full_tensor()`` of its results compares with the unsharded step's.
    A CUDA mesh over gloo is refused: DTensor's collectives crash there."""
    cfg = cfg or get_config(arch)
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    if mesh is not None and backend == "gloo" and device_type == "cuda":
        raise RuntimeError("a step on a CUDA mesh over gloo: DTensor's "
                           "collectives crash there; use nccl, a card a "
                           "rank, or a CPU mesh")
    if make is not None and (seed is not None or backend != "fake"):
        raise ValueError("make= makes rank 0's shards on the fake group; "
                         "seed= draws the global arguments")
    if backend != "fake" and seed is None:
        raise ValueError(f"backend={backend!r} runs each rank's program on "
                         f"its shards of the arguments drawn from seed=")
    rules, train_cfg, notes = _cell_settings(arch, cfg, shape, mesh,
                                             train_cfg, rules_override)
    gen = device = None
    if seed is not None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if device_type == "cuda" else torch.device(device_type))
        gen = torch.Generator(device=device).manual_seed(seed)
    step, args, specs = build_step(cfg, shape, train_cfg, attn_impl, mesh,
                                   rules, gen, device)
    with contextlib.ExitStack() as stack:
        if mesh is not None:
            dm = stack.enter_context(device_mesh(mesh, device_type, backend))
            stack.enter_context(sh.use_mesh(mesh, rules, dm))
            stack.enter_context(_implicit_replication())
            args = sh.shard_tree(args, specs, make)
        yield step, args, notes


def estimate_cell(arch: str, shape: Union[str, ShapeConfig], *,
                  cfg: Optional[ModelConfig] = None,
                  train_cfg: Optional[TrainConfig] = None,
                  attn_impl: Optional[str] = None,
                  mesh: Optional[sh.Mesh] = None,
                  rules_override: Optional[dict] = None,
                  notes: str = "") -> CellReport:
    """The cell's report (see the module docstring); ``shape`` a name of
    ``SHAPES`` or a ShapeConfig, ``cfg`` replacing the arch's config (a
    cut or smoke variant), ``train_cfg`` the cell's training overrides,
    ``attn_impl`` its attention route (``"einsum"`` or ``"chunked"``;
    default the reference's for the mode), ``mesh`` the mesh it is laid
    out on (default: one card) and ``rules_override`` the rules it
    changes there (default :data:`CELL_RULES_OVERRIDES`' entry)."""
    cfg = cfg or get_config(arch)
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    rep = CellReport(arch=arch, shape=shape.name,
                     mesh=MESH_NAME if mesh is None else mesh_name(mesh),
                     notes=notes, num_devices=1 if mesh is None else
                     mesh.size)
    skip = cell_is_skipped(arch, shape.name)
    if skip:
        rep.status, rep.error = "skipped", skip
        return rep
    t0 = time.perf_counter()
    try:
        with cell_program(arch, shape, mesh=mesh, cfg=cfg,
                          train_cfg=train_cfg, attn_impl=attn_impl,
                          rules_override=rules_override) as (step, args,
                                                             taken):
            rep.notes = " ".join(([rep.notes] if rep.notes else []) + taken)
            ins = _storages(args)
            grad = (torch.enable_grad if shape.mode == "train"
                    else torch.no_grad)
            with grad(), cost.Tally() as tally:
                tally.hold(args)
                out = step(*args)
                del step
            new = {k: n for k, n in _storages(out).items() if k not in ins}
            del out, args
        rep.compile_seconds = time.perf_counter() - t0
        rep.argument_bytes = float(sum(ins.values()))
        rep.output_bytes = float(sum(new.values()))
        rep.bytes_per_device = float(tally.peak)
        rep.temp_bytes = float(tally.peak - rep.argument_bytes)
        rep.fits = rep.bytes_per_device <= HBM_BYTES
        rep.hlo_flops = float(tally.flops)
        rep.xla_flops_raw = float(tally.raw_flops)
        rep.hlo_bytes = float(tally.bytes)
        rep.hlo_bytes_fused = rep.argument_bytes + rep.output_bytes
        rep.collective_bytes = float(tally.collective_bytes)
        rep.collective_counts = dict(tally.collective_counts)
        rep.compute_s = rep.hlo_flops / PEAK_FLOPS
        rep.memory_s = rep.hlo_bytes_fused / HBM_BW
        rep.collective_s = rep.collective_bytes / NET_BW
        terms = {"compute": rep.compute_s, "memory": rep.memory_s,
                 "collective": rep.collective_s}
        rep.dominant = max(terms, key=terms.get)
        rep.model_flops_global = model_flops(cfg, shape)
        total = rep.hlo_flops * rep.num_devices
        rep.useful_ratio = rep.model_flops_global / total if total else 0.0
    except Exception as e:  # noqa: BLE001 - report, don't crash the sweep
        rep.status = "error"
        rep.error = f"{type(e).__name__}: {e}"[:2000]
        rep.compile_seconds = time.perf_counter() - t0
    return rep


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
               attn_impl: Optional[str] = None,
               train_cfg: Optional[TrainConfig] = None,
               rules_override: Optional[dict] = None,
               mesh: Optional[sh.Mesh] = None,
               notes: str = "") -> CellReport:
    """The reference's ``lower_cell``: the cell on the production mesh,
    ``pod2x16x16`` if ``multi_pod`` else ``pod16x16`` (or on ``mesh``)."""
    return estimate_cell(
        arch, shape_name, attn_impl=attn_impl, train_cfg=train_cfg,
        rules_override=rules_override, notes=notes,
        mesh=mesh or make_production_mesh(multi_pod=multi_pod))


def _implicit_replication():
    """DTensor's implicit replication: a plain tensor a step makes (an
    ``arange`` of positions, a mask) meets DTensors as a replicated one,
    as XLA's partitioner replicates an unsharded constant."""
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()
