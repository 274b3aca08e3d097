"""Logical-axis sharding: one table maps logical tensor axes to mesh axes
(the reference's ``repro.distributed.sharding``, on the port).

Model code names tensor axes *logically* ("batch", "heads", ...); the
active rule set (chosen per arch x shape) resolves them to mesh axes.  The
rules read only a mesh's axis names and sizes, so they resolve for any
mesh shape, the production TPU shapes (16, 16) and (2, 16, 16) included,
which no card holds: a :class:`Mesh` may be a description without
devices.  With no device mesh active (one card) nothing is placed:
:func:`constraint` is the identity, and there is no process group.
Inside :func:`repro_torch.launch.mesh.device_mesh` a torch ``DeviceMesh``
of the mesh's shape is active, over a fake group (rank 0's program, a
trace) or a group of ranks (each rank's own): a tensor's spec becomes DTensor
placements (:func:`placements`, a mesh axis ``Shard(dim)`` of the tensor
axis that names it, else ``Replicate()``), :func:`shard_tree` lays a tree
out on it, and :func:`constraint` redistributes to the named sharding,
as the reference's ``with_sharding_constraint`` has XLA's partitioner
insert the collectives.

Rule presets:
 * TRAIN_RULES     — FSDP(data) x TP(model); batch over (pod, data).
 * DECODE_RULES    — batch over (pod, data), heads over model, KV seq local.
 * LONG_DECODE_RULES — batch=1: KV sequence sharded over data; heads over
   model.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import sys
import types
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


# Process-wide, not thread-local: the autograd engine runs a CUDA backward
# (and a checkpoint's recompute inside it) on its own device threads, which
# must see the mesh the forward ran under.
_STATE = types.SimpleNamespace()


def _get() -> tuple[Optional[Mesh], dict]:
    return (getattr(_STATE, "mesh", None), getattr(_STATE, "rules",
                                                   TRAIN_RULES))


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh], rules: Optional[dict] = None,
             device_mesh=None):
    """Activate (mesh, rules) for :func:`logical_spec` inside this block,
    and ``device_mesh`` (a torch ``DeviceMesh`` of ``mesh``'s shape) for
    :func:`constraint` and :func:`shard_tree`."""
    if device_mesh is not None and tuple(device_mesh.shape) != mesh.shape:
        raise ValueError(f"device mesh {tuple(device_mesh.shape)} is not "
                         f"the mesh {mesh.shape}")
    prev = _get() + (active_device_mesh(),)
    _STATE.mesh = mesh
    _STATE.rules = rules if rules is not None else TRAIN_RULES
    _STATE.device_mesh = device_mesh
    try:
        yield
    finally:
        _STATE.mesh, _STATE.rules, _STATE.device_mesh = prev


def active_mesh() -> Optional[Mesh]:
    return _get()[0]


def active_device_mesh():
    """The torch ``DeviceMesh`` tensors are laid out on, or ``None``."""
    return getattr(_STATE, "device_mesh", None)


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


def placements(spec: tuple, mesh: Mesh) -> list:
    """DTensor placements of a tensor whose axes resolve to ``spec`` (a
    :func:`logical_spec`): each mesh axis ``Shard(d)`` where tensor axis
    ``d`` names it (alone or in a tuple, in the mesh's order, as a
    ``PartitionSpec`` splits), ``Replicate()`` where none does."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate()] * len(mesh.axis_names)
    for dim, entry in enumerate(spec):
        for name in (entry if isinstance(entry, tuple) else (entry,)):
            if name is not None:
                out[mesh.axis_names.index(name)] = Shard(dim)
    return out


def shard_shape(shape, spec: tuple, mesh: Mesh) -> tuple:
    """The per-device shape of a ``shape`` tensor laid out by ``spec``
    (device 0's: a dimension that does not divide keeps the larger
    chunks first, as ``torch.chunk`` splits)."""
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    out = list(shape)
    for dim, entry in enumerate(spec):
        for name in (entry if isinstance(entry, tuple) else (entry,)):
            if name is not None:
                out[dim] = -(-out[dim] // sizes[name])
    return tuple(out)


def mesh_axes(logical_axis: str) -> list[int]:
    """The active mesh's axes (their indices) that ``logical_axis``
    resolves to under the active rules, in the mesh's order."""
    mesh = active_mesh()
    [entry] = logical_spec(logical_axis)
    return [mesh.axis_names.index(n) for n in
            (entry if isinstance(entry, tuple) else (entry,))
            if n is not None]


def splits(logical_axis: str) -> bool:
    """Whether the active device mesh splits ``logical_axis`` over more
    than one device (never with no device mesh, as on one card)."""
    if active_device_mesh() is None:
        return False
    return any(active_mesh().shape[d] > 1 for d in mesh_axes(logical_axis))


def contiguous_strides(shape) -> tuple:
    """The strides of a contiguous tensor of ``shape`` (no tensor made,
    so a tally counts nothing)."""
    out, n = [], 1
    for d in reversed(tuple(shape)):
        out.append(n)
        n *= d
    return tuple(reversed(out))


def is_distributed(x) -> bool:
    """Whether ``x`` is a DTensor (a tensor laid out on a device mesh)."""
    dtensor = sys.modules.get("torch.distributed.tensor")
    return dtensor is not None and isinstance(x, dtensor.DTensor)


def local(x):
    """The device's own shard of ``x`` (``x`` itself if not laid out)."""
    return x._local_tensor if is_distributed(x) else x


def distribute(x: torch.Tensor, axes: tuple, make=None):
    """``x`` laid out on the active device mesh by the logical ``axes``:
    a DTensor of ``x``'s global shape whose local shard is
    ``make(shape, dtype)`` where ``make`` is given (the fake group's
    trace: rank 0's shard, made for it), else this rank's shard of ``x``
    itself (:func:`take_shard`; a ``meta`` ``x`` gives an empty one).
    Non-tensors pass."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, torch.Tensor):
        return x
    mesh, dm = active_mesh(), active_device_mesh()
    spec = logical_spec(*axes)
    pl = placements(spec, mesh)
    if make is not None:
        loc = make(shard_shape(tuple(x.shape), spec, mesh), x.dtype)
    elif x.device.type == "meta":
        loc = torch.empty(shard_shape(tuple(x.shape), spec, mesh),
                          dtype=x.dtype, device=x.device)
    else:
        loc = take_shard(x, pl, dm)
    return DTensor.from_local(loc, dm, pl, run_check=False, shape=x.shape,
                              stride=contiguous_strides(x.shape))


def take_shard(x: torch.Tensor, pls, dm) -> torch.Tensor:
    """This rank's shard of the global ``x`` under placements ``pls`` on
    ``dm``, a contiguous copy (no collective): each mesh axis in order
    splits the tensor axis its ``Shard`` names into as many chunks as it
    has devices, as DTensor does (``torch.chunk``'s sizes, the larger
    chunks first, a chunk past the end empty), and keeps this rank's."""
    coord = dm.get_coordinate()
    for m, p in enumerate(pls):
        if p.is_shard():
            pieces = torch.chunk(x, dm.shape[m], dim=p.dim)
            x = (pieces[coord[m]] if coord[m] < len(pieces)
                 else x.narrow(p.dim, 0, 0))
    return x.clone(memory_format=torch.contiguous_format)


def shard_tree(tree: Any, spec_tree: Any, make=None) -> Any:
    """:func:`distribute` over a tree and its logical-axis tree (dicts,
    lists and NamedTuples alike; a leaf whose spec is ``()`` and which
    is no tensor, a host number, stays as it is).  On a group of ranks
    each rank calls it with the same global tree and keeps its shards."""
    if _is_spec_leaf(spec_tree):
        return distribute(tree, spec_tree, make)
    if isinstance(spec_tree, dict):
        return {k: shard_tree(tree[k], spec_tree[k], make) for k in tree}
    if isinstance(spec_tree, tuple) and hasattr(spec_tree, "_fields"):
        return type(tree)(*(shard_tree(t, s, make)
                            for t, s in zip(tree, spec_tree)))
    if isinstance(spec_tree, (list, tuple)):
        return type(tree)(shard_tree(t, s, make)
                          for t, s in zip(tree, spec_tree))
    raise TypeError(f"not a spec tree: {spec_tree!r}")


def _wrap(t, axes):
    """A device's shard ``t`` as the DTensor laid out by ``axes``."""
    from torch.distributed.tensor import DTensor
    dm, mesh = active_device_mesh(), active_mesh()
    spec = logical_spec(*axes)
    return DTensor.from_local(t, dm, placements(spec, mesh), run_check=False)


def einsum(eq: str, *operands, local: Optional[Callable] = None):
    """``torch.einsum(eq, *operands)``; where an operand is laid out on a
    device mesh, each mesh axis placed by one rule (XLA's partitioner's
    for a dot) and the einsum run on the local shards, never through
    DTensor's reshapes of it (which cannot flatten a split axis that is
    not the leftmost of its group): of the letters the operands split on
    that mesh axis, the one over the most operand bytes stays split (an
    operand holding it whole is sliced, one splitting another letter is
    gathered, a pending sum is reduced first), and the result is split
    along it, or a partial sum where it is contracted.  ``local`` computes
    the product of the local shards (default ``torch.einsum(eq, ...)``)."""
    local = local or functools.partial(torch.einsum, eq)
    if not any(is_distributed(o) for o in operands):
        return local(*operands)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    dm = next(o.device_mesh for o in operands if is_distributed(o))
    ins, out = eq.replace(" ", "").split("->")
    letters = ins.split(",")
    ops = [o if is_distributed(o) else
           DTensor.from_local(o, dm, [Replicate()] * dm.ndim,
                              run_check=False) for o in operands]
    ops = [o.redistribute(dm, [Replicate() if p.is_partial() else p
                               for p in o.placements])
           if any(p.is_partial() for p in o.placements) else o for o in ops]
    pls = [list(o.placements) for o in ops]
    grads = [[Replicate()] * dm.ndim for _ in ops]
    out_pl = []
    for m in range(dm.ndim):
        if dm.shape[m] == 1:          # one device holds every axis whole
            out_pl.append(Replicate())
            for i in range(len(ops)):
                pls[i][m] = grads[i][m] = Replicate()
            continue
        weight: dict[str, int] = {}
        for o, ls, pl in zip(ops, letters, pls):
            if pl[m].is_shard():
                key = ls[pl[m].dim]
                weight[key] = weight.get(key, 0) + o.numel() * \
                    o.element_size()
        keep = max(weight, key=weight.get) if weight else None
        for i, ls in enumerate(letters):
            if keep is not None and keep in ls:
                pls[i][m] = grads[i][m] = Shard(ls.index(keep))
            else:
                pls[i][m] = Replicate()
                grads[i][m] = Partial() if keep is not None else Replicate()
        out_pl.append(Replicate() if keep is None else
                      Shard(out.index(keep)) if keep in out else Partial())
    sizes = {c: n for o, ls in zip(ops, letters) for c, n in zip(ls, o.shape)}
    shape = torch.Size(sizes[c] for c in out)
    # a redistribute to the same layout would reduce a pending gradient
    # sum on its way back; skipping it leaves that to the operand's own
    # layout (an FSDP gather's way back is then the reduce-scatter)
    locs = [(o if tuple(pl) == tuple(o.placements) else
             o.redistribute(dm, pl)).to_local(grad_placements=g)
            for o, pl, g in zip(ops, pls, grads)]
    return DTensor.from_local(local(*locs), dm, out_pl,
                              run_check=False, shape=shape,
                              stride=contiguous_strides(shape))


def matmul(a, b):
    """``a @ b`` for a weight ``b`` (K, N) or its transpose; on a device
    mesh through :func:`einsum`, so the product runs on the local shards
    in the layout its operands name."""
    lead = "abcdefgh"[:a.dim() - 1]
    return einsum(f"{lead}k,kn->{lead}n", a, b, local=torch.matmul)


def local_map(fn: Callable, in_axes: tuple, out_axes: Any) -> Callable:
    """``fn`` run on each device's shards, as the reference's
    ``shard_map``: on a device mesh each tensor argument is laid out by
    its entry of ``in_axes`` (logical axes; ``None`` passes the argument
    as it is, a tensor not laid out given whole), ``fn`` gets the local
    shards (:func:`shard_of`), and its tensor results become DTensors
    laid out by ``out_axes`` (one tuple, or a tree of them as the results
    nest).
    The layouts are the op's sharding rule, for ops DTensor has none for
    (a scan, a cumulative sum) or lays out badly (an attention's
    flattened batch and head axes).  With no device mesh, ``fn``."""
    def mapped(*args, **kwargs):
        if active_device_mesh() is None:
            return fn(*args, **kwargs)
        locs = [shard_of(constraint(a, *axes)) if axes is not None
                and isinstance(a, torch.Tensor) else a
                for a, axes in zip(args, in_axes)]
        return wrap(fn(*locs, **kwargs), out_axes)

    def wrap(out, axes):
        if axes is None or not isinstance(out, (torch.Tensor, tuple, list)):
            return out
        if _is_spec_leaf(axes):
            return _wrap(out, axes)
        return type(out)(wrap(o, ax) for o, ax in zip(out, axes))
    return mapped


def shard_of(x):
    """``x.to_local()`` for a local computation over the batch shards:
    where ``x`` is whole on a mesh axis that splits the batch (a weight),
    each device's gradient of it is a partial sum over that axis."""
    from torch.distributed.tensor import Partial
    batch = set(mesh_axes("batch"))
    return x.to_local(grad_placements=[
        Partial() if p.is_replicate() and d in batch else p
        for d, p in enumerate(x.placements)])


def mesh_coordinate(logical_axis: str) -> tuple[int, int]:
    """(this device's index, the number of devices) along the mesh axes
    ``logical_axis`` resolves to (row-major over them): which shard of a
    split axis the device holds.  (0, 1) with no device mesh."""
    dm = active_device_mesh()
    if dm is None:
        return 0, 1
    coord = dm.get_coordinate() or [0] * dm.ndim
    idx, ways = 0, 1
    for d in mesh_axes(logical_axis):
        idx, ways = idx * dm.shape[d] + coord[d], ways * dm.shape[d]
    return idx, ways


def all_reduce(t: torch.Tensor, op: str, logical_axis: str, *,
               grad: str = "sum") -> torch.Tensor:
    """``t`` (a device's local tensor) reduced by ``op`` (``"sum"`` or
    ``"max"``) across the devices that split ``logical_axis``, one
    functional all-reduce a mesh axis; ``t`` with no device mesh.

    ``grad`` is the backward, which depends on what comes after the
    reduction (``psum``'s transpose, as JAX's replication checks pick
    it): ``"sum"`` all-reduces the gradient, right where each device's
    gradient of the result is its own part (the devices go on to use
    different slices of it); ``"same"`` passes it through, right where
    every device computes the same thing from the result, so each holds
    the whole gradient already (summing it would count it once a
    device)."""
    if grad not in ("sum", "same"):
        raise ValueError(f"grad {grad!r}: 'sum' or 'same'")
    dm = active_device_mesh()
    if dm is None:
        return t
    for d in mesh_axes(logical_axis):
        if dm.shape[d] > 1:
            t = _AllReduce.apply(t, op, (dm, d), grad)
    return t


def all_reduce_mesh_dim(t: torch.Tensor, op: str, mesh_dim: int
                        ) -> torch.Tensor:
    """``t`` (a device's local tensor) reduced by ``op`` across the
    active device mesh's axis ``mesh_dim``."""
    return _AllReduce.apply(t, op, (active_device_mesh(), mesh_dim), "sum")


class _AllReduce(torch.autograd.Function):
    """A functional all-reduce whose gradient is the all-reduced gradient
    (``grad="sum"``) or the gradient itself (``"same"``)."""

    @staticmethod
    def forward(ctx, t, op, group, grad):
        from torch.distributed._functional_collectives import (all_reduce,
                                                               wait_tensor)
        ctx.group, ctx.grad = group, grad
        return wait_tensor(all_reduce(t, op, group))

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed._functional_collectives import (all_reduce,
                                                               wait_tensor)
        if ctx.grad == "same":
            return grad, None, None, None
        return wait_tensor(all_reduce(grad.contiguous(), "sum",
                                      ctx.group)), None, None, None


def sum_grad(t: torch.Tensor, logical_axis: str) -> torch.Tensor:
    """``t`` itself, whose gradient is all-reduced (summed) across the
    devices that split ``logical_axis``: where each of them multiplies
    ``t`` by its own slice of a weight split on that axis, so each holds
    a part of ``t``'s gradient (the identity with its all-reduce
    transpose, the mirror of ``all_reduce(..., grad="same")``).  ``t``
    with no device mesh."""
    dm = active_device_mesh()
    if dm is None:
        return t
    for d in mesh_axes(logical_axis):
        if dm.shape[d] > 1:
            t = _SumGrad.apply(t, (dm, d))
    return t


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed._functional_collectives import (all_reduce,
                                                               wait_tensor)
        return wait_tensor(all_reduce(grad.contiguous(), "sum",
                                      ctx.group)), None


def all_gather(t: torch.Tensor, dim: int, logical_axis: str) -> torch.Tensor:
    """``t`` (a device's local tensor) concatenated along ``dim`` across
    the devices that split ``logical_axis`` (a functional all-gather a
    mesh axis, its gradient the reduce-scatter); ``t`` with no device
    mesh."""
    dm = active_device_mesh()
    if dm is None:
        return t
    from torch.distributed._functional_collectives import (
        all_gather_tensor_autograd, wait_tensor)
    for d in reversed(mesh_axes(logical_axis)):
        if dm.shape[d] > 1:
            t = wait_tensor(all_gather_tensor_autograd(t.contiguous(), dim,
                                                       (dm, d)))
    return t


def gather_weights(tree: Any) -> Any:
    """FSDP's gather: each laid-out tensor of ``tree`` (a layer's weights)
    replicated over the mesh axes that the ``w_data`` and ``embed_d``
    rules name, just before its use, as XLA's partitioner all-gathers an
    FSDP-sharded weight for a matmul whose batch lies on the same axis
    (the gradient's way back is the reduce-scatter).  Everything else
    passes."""
    dm = active_device_mesh()
    if dm is None:
        return tree
    from torch.distributed.tensor import Replicate
    dims = set(mesh_axes("w_data") + mesh_axes("embed_d"))

    def gather(x):
        if not is_distributed(x) or not dims:
            return x
        pl = list(x.placements)
        for d in dims:
            pl[d] = Replicate()
        return x.redistribute(dm, pl)

    def walk(t):
        return ({k: walk(v) for k, v in t.items()} if isinstance(t, dict)
                else gather(t))
    return walk(tree)


def constraint(x, *logical_axes: Optional[str]):
    """The reference's ``with_sharding_constraint``: ``x`` redistributed
    to the named sharding on the active device mesh (a tensor not yet
    laid out counts as replicated); with none active, as on one card,
    ``x`` itself."""
    dm = active_device_mesh()
    if dm is None:
        return x
    from torch.distributed.tensor import DTensor, Replicate
    if not is_distributed(x):
        x = DTensor.from_local(x, dm, [Replicate()] * dm.ndim,
                               run_check=False)
    # a mesh axis of one device holds the whole axis either way
    pl = [cur if n == 1 else want for cur, want, n in zip(
        x.placements, placements(logical_spec(*logical_axes),
                                 active_mesh()), dm.shape)]
    if tuple(pl) == tuple(x.placements):
        return x
    x = x.redistribute(dm, pl)
    loc = x.to_local()
    if loc.is_contiguous():
        return x
    # a slice of a replicated axis: made contiguous, as XLA lays it out
    return DTensor.from_local(loc.contiguous(), dm, pl, run_check=False,
                              shape=x.shape, stride=x.stride())


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
