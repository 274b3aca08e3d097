"""Cell estimates: (architecture x input shape) on one H100 -> FLOPs, bytes,
peak memory and roofline terms (the reference's ``repro.launch.lowering``,
which lowers a cell on a TPU mesh and costs its HLO).

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
  * the roofline terms at the H100 SXM's published peaks and the
    dominant one, and ``model_flops`` (6·N·D) with the useful ratio.

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

import dataclasses
import time
from typing import Optional, Union

import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.launch import cost
from repro_torch.models import model as M
from repro_torch.optim import cosine_schedule, make_optimizer
from repro_torch.tree import tree_leaves

# NVIDIA's published H100 SXM figures: dense bf16 tensor-core FLOP/s, HBM3
# bytes/s and the card's HBM (80 GB).  Published constants, not
# measurements.
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
HBM_BYTES = 80e9
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
# >=34B models).  On one card nothing is placed, so no estimate reads them.
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
    # one card: no collective runs, so these stay 0
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


def auto_grad_accum(shape: ShapeConfig) -> int:
    """Microbatches of a ``grad_accum=0`` train step on one card: about
    MICRO_TOKENS tokens each, the reference's rule with the whole batch
    on one device."""
    b = shape.global_batch
    return max(1, min(b, b * shape.seq_len // MICRO_TOKENS))


def _build_step(cfg: ModelConfig, shape: ShapeConfig,
                train_cfg: TrainConfig, attn_impl: Optional[str] = None):
    """(step, args): the cell's step and its ``meta`` arguments, its
    attention by ``attn_impl`` (default: the reference's, ``"einsum"``
    to train, ``"chunked"`` to prefill)."""
    ins = M.input_specs(cfg, shape)
    if shape.mode == "train":
        if train_cfg.grad_accum == 0:
            train_cfg = dataclasses.replace(
                train_cfg, grad_accum=auto_grad_accum(shape))
        opt = make_optimizer(
            train_cfg.optimizer,
            cosine_schedule(train_cfg.learning_rate, train_cfg.warmup_steps,
                            train_cfg.total_steps),
            weight_decay=train_cfg.weight_decay,
            grad_clip=train_cfg.grad_clip,
            moments_dtype=train_cfg.moments_dtype)
        # The schedule reads the step counter on the host: a number here.
        state = M.abstract_train_state(cfg, opt)._replace(step=0)
        step = M.make_train_step(cfg, opt, train_cfg,
                                 attn_impl=attn_impl or "einsum")
        return step, (state, ins["batch"])
    params = M.abstract_params(cfg)
    if shape.mode == "prefill":
        return (M.make_prefill_step(cfg, attn_impl=attn_impl or "chunked"),
                (params, ins["batch"]))
    # decode: one step at the cache's last slot (its position is a host
    # number on the port)
    cache = dict(ins["cache"], pos=(shape.kv_len or shape.seq_len) - 1)
    decode = M.make_decode_step(cfg)
    args = (params, cache, ins["tokens"])
    if cfg.mrope:
        args += (ins["positions"],)
    return decode, args


def _storages(tree) -> dict[int, int]:
    """{storage id: bytes} of the tensors of ``tree``."""
    out = {}
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            out[id(st)] = st.nbytes()
    return out


def estimate_cell(arch: str, shape: Union[str, ShapeConfig], *,
                  cfg: Optional[ModelConfig] = None,
                  train_cfg: Optional[TrainConfig] = None,
                  attn_impl: Optional[str] = None,
                  notes: str = "") -> CellReport:
    """The cell's report (see the module docstring); ``shape`` a name of
    ``SHAPES`` or a ShapeConfig, ``cfg`` replacing the arch's config (a
    cut or smoke variant), ``train_cfg`` the cell's training overrides
    and ``attn_impl`` its attention route (``"einsum"`` or
    ``"chunked"``; default the reference's for the mode)."""
    cfg = cfg or get_config(arch)
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    rep = CellReport(arch=arch, shape=shape.name, mesh=MESH_NAME,
                     notes=notes, num_devices=1)
    skip = cell_is_skipped(arch, shape.name)
    if skip:
        rep.status, rep.error = "skipped", skip
        return rep
    if train_cfg is None:
        over = CELL_TRAIN_OVERRIDES.get(arch, {})
        train_cfg = TrainConfig(grad_accum=0, **over)
        if over and shape.mode == "train":
            rep.notes = (rep.notes + " " if rep.notes else "") + \
                f"train overrides: {over}"
    t0 = time.perf_counter()
    try:
        step, args = _build_step(cfg, shape, train_cfg, attn_impl)
        ins = _storages(args)
        grad = torch.enable_grad if shape.mode == "train" else torch.no_grad
        with grad(), cost.Tally() as tally:
            tally.hold(args)
            out = step(*args)
            del step
        new = {k: n for k, n in _storages(out).items() if k not in ins}
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
        rep.compute_s = rep.hlo_flops / PEAK_FLOPS
        rep.memory_s = rep.hlo_bytes_fused / HBM_BW
        terms = {"compute": rep.compute_s, "memory": rep.memory_s,
                 "collective": rep.collective_s}
        rep.dominant = max(terms, key=terms.get)
        rep.model_flops_global = model_flops(cfg, shape)
        rep.useful_ratio = (rep.model_flops_global / rep.hlo_flops
                            if rep.hlo_flops else 0.0)
    except Exception as e:  # noqa: BLE001 - report, don't crash the sweep
        rep.status = "error"
        rep.error = f"{type(e).__name__}: {e}"[:2000]
        rep.compile_seconds = time.perf_counter() - t0
    return rep
