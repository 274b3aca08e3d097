"""Federated aggregation over a stacked ``pod`` axis (the reference's
``repro.distributed.fl_mesh``, its production mapping of the paper's
transport), on one card or over a group of ranks.

Each pod is one FL client; its model copy is the leading dimension of a
stacked parameter tree.  One FL round's aggregation is paper Eq. (1) /
FedAvg across that axis, every pod ending with the aggregate:

 * ``exact`` — the float32 mean over the pods, cast back to the leaf's
   dtype.  Each leaf's (P, n) view folds on the **fedavg kernel** with
   weights 1/P.
 * ``int8`` — the compressed exchange: each pod's copy is quantized
   *row-wise* (absmax over the last axis: ``scale = max(absmax, 1e-12) /
   127``, ``q = clip(rint(x / scale), -127, 127)``), dequantized
   (``q * scale``) and averaged over the pods.  The codec runs on the
   **quantize** and **dequantize kernels** (one block a row, the leaf's
   last axis) over the (P * rows, d) view, the mean on fedavg.  Its error
   against ``exact`` is at most ``absmax / 254`` a row, the largest over
   the pods.

Over a group of ranks (:mod:`repro_torch.distributed.ranks`) the stacked
tree is laid out with its pod axis split over the mesh's ``pod`` axis, as
``shard_tree(stacked, stacked_specs(specs))`` lays it out under rules
that map ``fl_pod`` to ``pod``, and each rank holds its pods' rows of its
shard of every leaf.  ``exact`` all-gathers those rows across the pods in
the leaf's own dtype (2 B a bf16 parameter); ``int8`` quantizes them on
the quantize kernel and all-gathers the int8 codes (1 B a value) and
float32 scales (4 B a row), then dequantizes on the dequantize kernel.
Both fold the gathered rows on fedavg in pod order: the same kernels on
the same values in the same order as the one-process aggregation of the
whole stack, so every rank's shard of the result is bitwise that
aggregation's.  Where other mesh axes split a leaf's last axis, a row's
absmax is its whole row's, all-reduced (max) across them first (the
reference's ``shard_map`` is manual over ``pod`` only) and handed to the
quantize kernel as one more column of the row.

On a CUDA tensor every step launches its kernel (a kernel that cannot
build or launch raises); on a CPU tensor each wrapper runs its plain
version.  fedavg folds ``sum_k fl(w * x_k)`` in pod order where the
reference's ``jnp.mean`` sums and then divides: the exact means agree bit
for bit at P = 2 (w = 0.5 is exact) and within a few ulp otherwise.  The
int8 means differ by up to one ulp at P = 2 as well, where XLA's CPU
backend contracts the reference's ``q * scale`` into the pod sum (a fused
multiply-add), which the port's separate dequantize and fold do not.

Under a profiler (:mod:`repro_torch.spans`) a call is one
``repro_torch.fl_mesh.aggregate`` range, and each leaf of a plain tree
one range of each of its phases: ``fl_mesh.cast`` (to float32),
``fl_mesh.codec`` (``int8``: quantize and dequantize), ``fl_mesh.fold``
(the weights and fedavg), ``fl_mesh.cast_back`` and ``fl_mesh.broadcast``
(each pod's copy), every device operation of the leaf inside one of them.
A leaf laid out over ranks records its fold.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch

from repro_torch.distributed import ranks
from repro_torch.distributed.sharding import Mesh, is_distributed, map_specs
from repro_torch.kernels.fedavg import ops as fedavg_ops
from repro_torch.kernels.quantize import ops as quant_ops
from repro_torch.spans import span
from repro_torch.tree import tree_map

QBLOCK = 1024
MODES = ("exact", "int8")


def client_mesh(devices: Optional[Sequence[torch.device]] = None) -> Mesh:
    """A 1-D ``("clients",)`` mesh: over the group's ranks where this
    process joined a group (:mod:`repro_torch.distributed.ranks`; a
    description, each rank on its own device), else over ``devices``, by
    default the visible cards (the CPU where there is none, as
    ``jax.devices()`` gives the host).  The fleet's ``shard`` train
    backend (:class:`repro_torch.core.client_compute.ShardBackend`)
    consults it."""
    if devices is None and ranks.active():
        return Mesh(("clients",), (ranks.world_size(),))
    if devices is None:
        n = torch.cuda.device_count()
        devices = ([torch.device("cuda", i) for i in range(n)] if n
                   else [torch.device("cpu")])
    devices = tuple(torch.device(d) for d in devices)
    return Mesh(("clients",), (len(devices),), devices)


def stack_for_pods(params: Any, n_pods: int) -> Any:
    """A template tree replicated into per-pod copies (leading pod dim)."""
    return tree_map(lambda x: x.unsqueeze(0).expand(
        (n_pods,) + tuple(x.shape)).contiguous(), params)


def stacked_specs(param_specs: Any) -> Any:
    return map_specs(lambda s: ("fl_pod",) + s, param_specs)


def _quantize_leaf(x: torch.Tensor):
    """A leaf's values, flattened, as (codes (nb, QBLOCK) int8, scales
    (nb,) f32) in 1024-value blocks (the tail block zero-padded)."""
    flat = x.reshape(1, -1).to(torch.float32).contiguous()
    q, scale = quant_ops.quantize(flat, QBLOCK)
    return q.view(-1, QBLOCK), scale.view(-1)


def _dequantize_leaf(q: torch.Tensor, scale: torch.Tensor, shape, dtype):
    """Per-pod codes (P, nb, QBLOCK) and scales (P, nb) -> the (P,) +
    ``shape`` leaf in ``dtype``."""
    n = 1
    for s in shape:
        n *= s
    pods, nb = scale.shape
    out = quant_ops.dequantize(q.reshape(pods, nb * QBLOCK).contiguous(),
                               scale.contiguous(), n, QBLOCK)
    return out.reshape((pods,) + tuple(shape)).to(dtype)


def _has_rows(x) -> None:
    """Raise unless the stacked leaf ``x`` has rows to quantize."""
    if x.dim() < 2:
        raise ValueError(
            f"int8 pod aggregation quantizes each row of a leaf's last "
            f"axis; a 0-d parameter (stacked {tuple(x.shape)}) has none")


def _fold(vals: torch.Tensor) -> torch.Tensor:
    """The mean of ``vals``' P rows (float32, (P, n)) on the fedavg
    kernel, weights 1/P, in pod order."""
    pods = vals.shape[0]
    with span("fl_mesh.fold"):
        weights = torch.full((pods,), 1.0 / pods, dtype=torch.float32,
                             device=vals.device)
        return fedavg_ops.fedavg(vals, weights)


def pod_mean(x: torch.Tensor, mode: str = "exact") -> torch.Tensor:
    """The float32 mean over the leading pod axis of ``x`` (P, ...): of the
    values themselves (``exact``) or of their row-wise int8 round trip
    (``int8``); shape ``x.shape[1:]``, before any cast back."""
    if mode not in MODES:
        raise ValueError(mode)
    if x.dim() < 1:
        raise ValueError("a stacked leaf leads with the pod axis")
    pods = x.shape[0]
    if mode == "exact":
        with span("fl_mesh.cast"):
            vals = x.reshape(pods, -1).to(torch.float32).contiguous()
    else:
        _has_rows(x)
        d = x.shape[-1]
        with span("fl_mesh.cast"):
            rows = x.to(torch.float32).reshape(-1, d).contiguous()
        with span("fl_mesh.codec"):
            q, scale = quant_ops.quantize(rows, d)
            vals = quant_ops.dequantize(q, scale, d, d).view(pods, -1)
    return _fold(vals).view(x.shape[1:])


def _pod_mean_ranks(x, mesh: Mesh, mode: str,
                    traffic: Optional[ranks.Traffic]):
    """:func:`pod_mean` of a stacked leaf laid out over ranks, its pod axis
    (dim 0) split over ``mesh``'s ``pod`` axis: this rank's shard of the
    float32 mean, shape its shard's less the pod axis."""
    dm = x.device_mesh
    pod = mesh.axis_names.index("pod")
    split = [d for d, p in enumerate(x.placements)
             if p.is_shard() and p.dim == 0]
    if split != [pod]:
        raise ValueError(f"a stacked leaf splits its pod axis over the "
                         f"mesh's 'pod' axis alone, not {x.placements}")
    loc = x.to_local()
    pods = dm.shape[pod]
    if loc.shape[0] != 1:
        raise ValueError(f"each rank holds one pod's rows, not "
                         f"{loc.shape[0]} (stacked {tuple(x.shape)} over "
                         f"{pods} pods)")
    group = dm.get_group(pod)
    if mode == "exact":
        rows = ranks.all_gather(loc.reshape(1, -1), group, traffic)
        vals = rows.to(torch.float32)
    else:
        _has_rows(x)
        d = loc.shape[-1]
        rows = loc.to(torch.float32).reshape(-1, d).contiguous()
        across = [m for m, p in enumerate(x.placements)
                  if p.is_shard() and p.dim == x.dim() - 1]
        if across:
            # the whole row's absmax, as one more column: the kernel's
            # absmax is then the row's, and so is its scale
            peak = rows.abs().amax(dim=-1, keepdim=True)
            for m in across:
                peak = ranks.all_reduce(peak, "max", dm.get_group(m),
                                        traffic)
            q, scale = quant_ops.quantize(
                torch.cat([rows, peak], dim=1).contiguous(), d + 1)
            q = q[:, :d].contiguous()
        else:
            q, scale = quant_ops.quantize(rows, d)
        q = ranks.all_gather(q, group, traffic)
        scale = ranks.all_gather(scale, group, traffic)
        vals = quant_ops.dequantize(q, scale, d, d).view(pods, -1)
    return _fold(vals).view(loc.shape[1:])


def make_fl_aggregate(mesh: Mesh, *, mode: str = "exact",
                      traffic: Optional[ranks.Traffic] = None):
    """``agg(stacked) -> stacked`` with every pod holding the aggregate
    (paper Eq. 1 generalized to P pods), each pod's copy its own storage.

    A stacked tree of plain tensors is aggregated in this process, its
    pods the leading axis (``mesh`` places them in the reference, and is
    not read).  A tree laid out over a group of ranks (DTensors, the pod
    axis split over ``mesh``'s ``pod`` axis) is aggregated across the
    ranks and comes back in the same layout; ``traffic`` (a
    :class:`~repro_torch.distributed.ranks.Traffic`) then counts the
    bytes this rank sent and received."""
    if mode not in MODES:
        raise ValueError(mode)

    def leaf(x):
        if is_distributed(x):
            from torch.distributed.tensor import DTensor
            mean = _pod_mean_ranks(x, mesh, mode, traffic)
            return DTensor.from_local(mean.to(x.dtype).unsqueeze(0),
                                      x.device_mesh, x.placements,
                                      run_check=False, shape=x.shape,
                                      stride=x.stride())
        mean = pod_mean(x, mode)
        with span("fl_mesh.cast_back"):
            mean = mean.to(x.dtype)
        with span("fl_mesh.broadcast"):
            return mean.unsqueeze(0).expand(x.shape).contiguous()

    def agg(stacked):
        with span("fl_mesh.aggregate"):
            return tree_map(leaf, stacked)
    return agg
