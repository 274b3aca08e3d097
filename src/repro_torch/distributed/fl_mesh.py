"""Federated aggregation over a stacked ``pod`` axis (the reference's
``repro.distributed.fl_mesh``, its production mapping of the paper's
transport, on one card).

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

On a CUDA tensor every step launches its kernel (a kernel that cannot
build or launch raises); on a CPU tensor each wrapper runs its plain
version.  fedavg folds ``sum_k fl(w * x_k)`` in pod order where the
reference's ``jnp.mean`` sums and then divides: the exact means agree bit
for bit at P = 2 (w = 0.5 is exact) and within a few ulp otherwise.  The
int8 means differ by up to one ulp at P = 2 as well, where XLA's CPU
backend contracts the reference's ``q * scale`` into the pod sum (a fused
multiply-add), which the port's separate dequantize and fold do not.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch

from repro_torch.distributed.sharding import Mesh, map_specs
from repro_torch.kernels.fedavg import ops as fedavg_ops
from repro_torch.kernels.quantize import ops as quant_ops
from repro_torch.tree import tree_map

QBLOCK = 1024
MODES = ("exact", "int8")


def client_mesh(devices: Optional[Sequence[torch.device]] = None) -> Mesh:
    """A 1-D ``("clients",)`` mesh over ``devices``, by default the
    visible cards (the CPU where there is none, as ``jax.devices()`` gives
    the host).  The fleet's ``shard`` train backend
    (:class:`repro_torch.core.client_compute.ShardBackend`) consults it."""
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
        vals = x.reshape(pods, -1).to(torch.float32).contiguous()
    else:
        if x.dim() < 2:
            raise ValueError(
                f"int8 pod aggregation quantizes each row of a leaf's last "
                f"axis; a 0-d parameter (stacked {tuple(x.shape)}) has none")
        d = x.shape[-1]
        rows = x.to(torch.float32).reshape(-1, d).contiguous()
        q, scale = quant_ops.quantize(rows, d)
        vals = quant_ops.dequantize(q, scale, d, d).view(pods, -1)
    weights = torch.full((pods,), 1.0 / pods, dtype=torch.float32,
                         device=x.device)
    mean = fedavg_ops.fedavg(vals, weights)
    return mean.view(x.shape[1:])


def make_fl_aggregate(mesh: Mesh, *, mode: str = "exact"):
    """``agg(stacked) -> stacked`` with every pod holding the aggregate
    (paper Eq. 1 generalized to P pods), each pod's copy its own storage.
    ``mesh`` places the pods in the reference; on one card they are the
    leading axis, and it is not read."""
    if mode not in MODES:
        raise ValueError(mode)

    def leaf(x):
        return pod_mean(x, mode).to(x.dtype).unsqueeze(0).expand(
            x.shape).contiguous()

    def agg(stacked):
        return tree_map(leaf, stacked)
    return agg
