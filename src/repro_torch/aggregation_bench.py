"""Aggregation strategies on the port: the paper's Eq. 1 against weighted
FedAvg, and the fedavg kernel against its plain version.

The counterpart of the reference's ``benchmarks/aggregation.py``.  The
first row quantifies the order dependence of the paper's sequential
pairwise average (later arrivals dominate: the k-th last client carries
weight 2^-k) over every order of four 1,000-parameter clients, on the
host, as the reference does.  Then the fused fedavg kernel
(:func:`repro_torch.kernels.fedavg.ops.fedavg`: on the card the CUDA
kernel, on the CPU its plain version) and the plain PyTorch version
(:func:`repro_torch.kernels.fedavg.ref.fedavg`) fold K = 8 clients of
N = 4,000,000 parameters on the device: one warm call, then the mean of
three, each ending in ``torch.cuda.synchronize()`` on the card.  The rows
``aggregation/fedavg_kernel`` and ``aggregation/fedavg_torch_ref`` are the
reference's ``fedavg_kernel_interpret`` and ``fedavg_jnp_ref``.  The two
folds must agree bit for bit, the kernel's contract: where they do not,
the suite raises :class:`repro_torch.kernels.KernelError`.

    PYTHONPATH=src python -m repro_torch.bench_run --device cpu \\
        --only aggregation
"""

from __future__ import annotations

import itertools
import time

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core.aggregation import fedavg, pairwise_average
from repro_torch.kernels import KernelError
from repro_torch.kernels.fedavg import ops as fedavg_ops
from repro_torch.kernels.fedavg import ref as fedavg_ref

K, N = 8, 4_000_000


def order_dependence(clients: list[dict]) -> tuple[float, float]:
    """Eq. 1 folded from zero over every order of ``clients``: the largest
    L2 distance between two orders' results, and the largest from
    FedAvg's."""
    g0 = {"w": np.zeros_like(clients[0]["w"])}
    outs = []
    for perm in itertools.permutations(range(len(clients))):
        g = g0
        for i in perm:
            g = pairwise_average(g, clients[i])
        outs.append(g["w"])
    spread = float(max(np.linalg.norm(a - b) for a in outs for b in outs))
    fa = fedavg(clients, backend="numpy")["w"]
    return spread, float(max(np.linalg.norm(o - fa) for o in outs))


def bench(n: int = N):
    """``(row name, wall us, derived fields)``, as the reference's
    ``bench()``; ``n`` is the timed fold's width."""
    rows = []
    rng = np.random.default_rng(0)
    clients = [{"w": rng.standard_normal(1000).astype(np.float32)}
               for _ in range(4)]
    spread, worst = order_dependence(clients)
    rows.append(("aggregation/pairwise_order_dependence", 0.0,
                 f"perm_spread_l2={spread:.3f}"
                 f";max_dev_from_fedavg={worst:.3f}"))

    dev = _device.resolve()
    stack = torch.from_numpy(
        rng.standard_normal((K, n)).astype(np.float32)).to(dev)
    w = torch.from_numpy(rng.uniform(0.5, 1.5, K).astype(np.float32)).to(dev)

    def call(fn):
        out = fn(stack, w)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out

    outs = {}
    for name, fn in (("kernel", fedavg_ops.fedavg),
                     ("torch_ref", fedavg_ref.fedavg)):
        call(fn)
        t0 = time.perf_counter()
        reps = 3
        for _ in range(reps):
            outs[name] = call(fn)
        us = (time.perf_counter() - t0) * 1e6 / reps
        rows.append((f"aggregation/fedavg_{name}", us, f"K={K};N={n}"))
    if not torch.equal(outs["kernel"].view(torch.int32),
                       outs["torch_ref"].view(torch.int32)):
        raise KernelError(f"fedavg at ({K}, {n}): the kernel's fold differs "
                          f"from the plain version's")
    return rows
