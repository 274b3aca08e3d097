"""One rank of a real process group, and the collectives the FL paths run
over one.

R processes, each started by ``torchrun`` (``RANK`` / ``WORLD_SIZE`` /
``LOCAL_RANK`` and a rendezvous address in the environment) or by a
launcher that passes the rank, the world size and a ``FileStore`` path,
each call :func:`join` once.  The backend is the caller's choice, never
a guess:

 * ``"gloo"`` takes any layout: ranks on the CPU, or several ranks
   sharing one card;
 * ``"nccl"`` needs a card a rank, and :func:`join` raises when the
   ranks outnumber the visible cards (NCCL will not put two ranks on one
   device).

torch's ``"fake"`` backend (:func:`repro_torch.launch.mesh.device_mesh`'s
trace of rank 0's program) is no group of ranks and is never joined here.

The group has a timeout (:data:`GROUP_TIMEOUT_S`), so a rank that dies
stops the others' next collective instead of hanging them.

On the card, gloo takes the in-place collectives
(``all_gather_into_tensor``, ``all_reduce``) of CUDA tensors from ranks
sharing one card, but with torch 2.11 its functional collectives, which
DTensor's redistributions call, end the process with SIGSEGV on a CUDA
tensor (both seen on an H100).  So :func:`all_gather` and
:func:`all_reduce` call the in-place ones, on the tensor's own device,
and a model's step on a CUDA mesh over gloo, which would redistribute
DTensors, is refused (:func:`repro_torch.launch.lowering.cell_program`).
Gloo takes no int16 tensor.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import datetime
import os
import sys
from typing import Iterator, Optional

import torch

BACKENDS = ("gloo", "nccl")
#: seconds a collective waits for the other ranks before it raises
GROUP_TIMEOUT_S = 60


@dataclasses.dataclass
class Traffic:
    """Bytes this rank sent and received through :func:`all_gather` and
    :func:`all_reduce`, and their calls by kind.  An all-gather over P
    ranks sends this rank's block to the P - 1 others and receives
    theirs; an all-reduce moves 2 (P - 1) / P of its buffer each way (a
    ring's share, the least any algorithm moves)."""
    sent: int = 0
    received: int = 0
    calls: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return None if v is None else int(v)


def join(backend: str, *, device_type: str = "cuda",
         rank: Optional[int] = None, world_size: Optional[int] = None,
         store_path: Optional[str] = None,
         timeout_s: float = GROUP_TIMEOUT_S) -> torch.device:
    """Join the group this process was started in and return its device.

    ``rank`` / ``world_size`` default to torchrun's ``RANK`` /
    ``WORLD_SIZE``; with ``store_path`` the ranks meet in a ``FileStore``
    there, else at torchrun's ``MASTER_ADDR`` / ``MASTER_PORT``.  On
    ``device_type="cuda"`` the rank takes card ``LOCAL_RANK %
    device_count()`` as its current device (and says so on stderr when
    ranks share a card); on ``"cpu"`` its device is the CPU."""
    import torch.distributed as dist
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS} (the "
                         f"fake group is launch.mesh.device_mesh's trace)")
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    rank = _env_int("RANK") if rank is None else rank
    world_size = _env_int("WORLD_SIZE") if world_size is None else world_size
    if rank is None or world_size is None:
        raise RuntimeError("no rank: start the process under torchrun, or "
                           "pass rank= and world_size=")
    local = _env_int("LOCAL_RANK")
    local = rank if local is None else local
    if device_type == "cuda":
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("device_type='cuda' but no card is visible")
        if backend == "nccl" and cards < world_size:
            raise RuntimeError(
                f"nccl needs a card a rank: {world_size} ranks, {cards} "
                f"visible card(s); use gloo to share a card")
        device = torch.device("cuda", local % cards)
        torch.cuda.set_device(device)
        if world_size > cards:
            print(f"rank {rank} of {world_size}: {device} ({world_size} "
                  f"ranks share {cards} card(s))", file=sys.stderr)
    elif device_type == "cpu":
        if backend == "nccl":
            raise RuntimeError("nccl runs on cards; use gloo on the CPU")
        device = torch.device("cpu")
    else:
        raise ValueError(f"device_type {device_type!r}: 'cuda' or 'cpu'")
    store = (None if store_path is None
             else dist.FileStore(store_path, world_size))
    dist.init_process_group(
        backend, store=store, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
    return device


def leave() -> None:
    """Destroy this process's group (if it joined one)."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


@contextlib.contextmanager
def group(backend: str, **kwargs) -> Iterator[torch.device]:
    """:func:`join` on entry, :func:`leave` on exit; yields the device."""
    device = join(backend, **kwargs)
    try:
        yield device
    finally:
        leave()


def active() -> bool:
    """Whether this process has joined a group of ranks (gloo or nccl;
    the fake group of a trace is none)."""
    import torch.distributed as dist
    return (dist.is_available() and dist.is_initialized()
            and dist.get_backend() in BACKENDS)


def rank() -> int:
    """This process's rank, 0 with no group."""
    import torch.distributed as dist
    return dist.get_rank() if active() else 0


def world_size() -> int:
    """The group's ranks, 1 with no group."""
    import torch.distributed as dist
    return dist.get_world_size() if active() else 1


def all_gather(t: torch.Tensor, group=None,
               traffic: Optional[Traffic] = None) -> torch.Tensor:
    """Each rank's ``t`` (equal shapes) concatenated along dim 0 in the
    group's rank order, on ``t``'s device and in its dtype."""
    import torch.distributed as dist
    t = t.contiguous()
    ways = dist.get_world_size(group)
    out = torch.empty((ways * t.shape[0],) + tuple(t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, t, group=group)
    if traffic is not None:
        n = t.numel() * t.element_size()
        traffic.sent += n * (ways - 1)
        traffic.received += n * (ways - 1)
        traffic.calls["all_gather"] += 1
    return out


def all_reduce(t: torch.Tensor, op: str, group=None,
               traffic: Optional[Traffic] = None) -> torch.Tensor:
    """A copy of ``t`` reduced by ``op`` (``"sum"`` or ``"max"``) over the
    group's ranks."""
    import torch.distributed as dist
    ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
    out = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=ops[op], group=group)
    if traffic is not None:
        ways = dist.get_world_size(group)
        n = 2 * (ways - 1) * out.numel() * out.element_size() // ways
        traffic.sent += n
        traffic.received += n
        traffic.calls["all_reduce"] += 1
    return out
