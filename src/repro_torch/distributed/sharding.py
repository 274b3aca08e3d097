"""Logical-axis sharding: one table maps logical tensor axes to mesh axes
(the reference's ``repro.distributed.sharding``, on the port).

Model code names tensor axes *logically* ("batch", "heads", ...); the
active rule set (chosen per arch x shape) resolves them to mesh axes.  The
rules read only a mesh's axis names and sizes, so they resolve for any
mesh shape, the production TPU shapes (16, 16) and (2, 16, 16) included,
which no card holds: a :class:`Mesh` may be a description without
devices.  On one card nothing is placed: :func:`constraint` is the
identity, and there is no process group.

Rule presets:
 * TRAIN_RULES     — FSDP(data) x TP(model); batch over (pod, data).
 * DECODE_RULES    — batch over (pod, data), heads over model, KV seq local.
 * LONG_DECODE_RULES — batch=1: KV sequence sharded over data; heads over
   model.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Callable, NamedTuple, Optional

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named mesh axes and their sizes, and the devices laid out on them
    (row-major over ``shape``), or ``None`` for a description."""
    axis_names: tuple[str, ...]
    shape: tuple[int, ...]
    devices: Optional[tuple[torch.device, ...]] = None

    def __post_init__(self):
        if len(self.axis_names) != len(self.shape):
            raise ValueError(f"mesh axes {self.axis_names} and shape "
                             f"{self.shape} differ in rank")
        if self.devices is not None and len(self.devices) != self.size:
            raise ValueError(f"a {self.shape} mesh needs {self.size} "
                             f"devices, got {len(self.devices)}")

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


# logical axis -> mesh axis (or tuple of mesh axes, or None = replicated)
TRAIN_RULES: dict[str, object] = {
    "batch": ("pod", "data"),
    "act_seq": None,
    "heads": "model",
    "kv_heads": None,
    "head_dim": None,
    "d_ff": "model",
    "experts": "model",
    "vocab": "model",
    "embed_d": "data",        # FSDP axis of the embedding table
    "w_data": "data",         # FSDP axis of weight matrices
    "layers": None,
    "kv_seq": None,
    "state": None,
}

DECODE_RULES = dict(TRAIN_RULES, **{
    "w_data": None,           # weights replicated across data at serve time
    "embed_d": None,
    "batch": ("pod", "data"),
    "kv_seq": "model",        # KV cache sequence sharded over TP
})

LONG_DECODE_RULES = dict(DECODE_RULES, **{
    "batch": None,            # global_batch=1 cannot shard
    "kv_seq": ("pod", "data", "model"),  # 500k KV over every available axis
})


def rules_for(cfg, shape, mesh: Mesh, *, base: dict | None = None) -> dict:
    """The rule preset for (arch, shape) on ``mesh``, dropping any
    logical->mesh mapping whose dimension does not divide evenly (36 or 25
    heads on a 16-way model axis fall back to replication; the MLP d_ff
    TP still applies)."""
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    tp = sizes.get("model", 1)
    dp = sizes.get("data", 1)
    pod = sizes.get("pod", 1)
    if base is None:
        if shape.mode == "train":
            base = TRAIN_RULES
        elif shape.name == "long_500k":
            base = LONG_DECODE_RULES
        else:
            base = DECODE_RULES

    rules = dict(base)

    def drop_if(axis: str, dim: int, ways: int):
        if rules.get(axis) is not None and dim % ways != 0:
            rules[axis] = None

    drop_if("heads", cfg.num_heads, tp)
    drop_if("kv_heads", cfg.num_kv_heads, tp)
    if cfg.d_ff:
        drop_if("d_ff", cfg.d_ff, tp)
    drop_if("vocab", cfg.padded_vocab, tp)
    drop_if("d_inner", cfg.d_model, tp)          # hybrid SSM inner == d
    drop_if("w_data", cfg.d_model, dp)
    drop_if("embed_d", cfg.d_model, dp)
    # batch: try (pod, data); fall back to data only; then replicate
    b = shape.global_batch
    if rules.get("batch") is not None:
        if b % (pod * dp) == 0:
            rules["batch"] = tuple(a for a in ("pod", "data")
                                   if a in sizes) or None
        elif b % dp == 0:
            rules["batch"] = "data"
        else:
            rules["batch"] = None
    if rules.get("kv_seq") is not None and shape.mode in ("decode",
                                                          "prefill"):
        target = rules["kv_seq"]
        names = target if isinstance(target, tuple) else (target,)
        ways = 1
        for nm in names:
            ways *= sizes.get(nm, 1)
        kv_len = shape.kv_len or shape.seq_len
        if kv_len % ways != 0:
            rules["kv_seq"] = None
    return rules


_STATE = threading.local()


def _get() -> tuple[Optional[Mesh], dict]:
    return (getattr(_STATE, "mesh", None), getattr(_STATE, "rules",
                                                   TRAIN_RULES))


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh], rules: Optional[dict] = None):
    """Activate (mesh, rules) for :func:`logical_spec` inside this block."""
    prev = _get()
    _STATE.mesh = mesh
    _STATE.rules = rules if rules is not None else TRAIN_RULES
    try:
        yield
    finally:
        _STATE.mesh, _STATE.rules = prev


def active_mesh() -> Optional[Mesh]:
    return _get()[0]


def logical_spec(*logical_axes: Optional[str]) -> tuple:
    """Logical axis names resolved to mesh axes under the active rules, one
    entry per axis (the entries of the reference's ``PartitionSpec``):
    a mesh axis name, a tuple of them, or ``None``; mesh axes the active
    mesh does not have are dropped."""
    mesh, rules = _get()
    names = set(mesh.axis_names) if mesh is not None else set()
    out = []
    for ax in logical_axes:
        if ax is None:
            out.append(None)
            continue
        target = rules.get(ax)
        if target is None:
            out.append(None)
        elif isinstance(target, tuple):
            kept = tuple(t for t in target if t in names)
            out.append(kept if len(kept) > 1 else (kept[0] if kept else None))
        else:
            out.append(target if target in names else None)
    return tuple(out)


def constraint(x, *logical_axes: Optional[str]):
    """The reference's ``with_sharding_constraint``: on one card there is
    nothing to place, so ``x`` itself."""
    return x


class NamedSharding(NamedTuple):
    """A mesh and the per-axis spec of a tensor laid out on it."""
    mesh: Mesh
    spec: tuple


def named_sharding(*logical_axes: Optional[str]) -> Optional[NamedSharding]:
    mesh, _ = _get()
    if mesh is None:
        return None
    return NamedSharding(mesh, logical_spec(*logical_axes))


def _is_spec_leaf(x) -> bool:
    """A logical-axes tuple: a *plain* tuple of axis names / None.
    NamedTuples (e.g. TrainState) are containers, not leaves."""
    return (type(x) is tuple
            and all(e is None or isinstance(e, str) for e in x))


def map_specs(fn: Callable[[tuple], Any], spec_tree: Any) -> Any:
    """``fn`` applied to each logical-axes tuple of ``spec_tree`` (dicts,
    lists and NamedTuples are containers)."""
    if _is_spec_leaf(spec_tree):
        return fn(spec_tree)
    if isinstance(spec_tree, dict):
        return {k: map_specs(fn, v) for k, v in spec_tree.items()}
    if isinstance(spec_tree, tuple) and hasattr(spec_tree, "_fields"):
        return type(spec_tree)(*(map_specs(fn, v) for v in spec_tree))
    if isinstance(spec_tree, (list, tuple)):
        return type(spec_tree)(map_specs(fn, v) for v in spec_tree)
    raise TypeError(f"not a spec tree: {spec_tree!r}")


def tree_shardings(spec_tree):
    """A tree of logical-axis tuples mapped to :class:`NamedSharding`s on
    the active mesh."""
    mesh, _ = _get()
    if mesh is None:
        raise RuntimeError("tree_shardings requires an active use_mesh()")
    return map_specs(lambda axes: NamedSharding(mesh, logical_spec(*axes)),
                     spec_tree)
