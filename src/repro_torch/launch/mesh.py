"""Mesh construction (the reference's ``repro.launch.mesh``).

The production meshes are the reference's TPU v5e layouts, (data=16,
model=16) for one pod and (pod=2, data=16, model=16) for two: on the port
they are descriptions (a :class:`~repro_torch.distributed.sharding.Mesh`
without devices), which the sharding rules resolve against and which no
single card holds.  In the multi-pod mesh the ``pod`` axis is the
federated-learning client axis (:mod:`repro_torch.distributed.fl_mesh`).

:func:`device_mesh` gives one rank's view of such a mesh, a torch
``DeviceMesh`` of its shape, over the group its ``backend`` names:

 * ``"fake"`` (a trace): a group of torch's ``"fake"`` backend (world
   size the mesh's size, this process rank 0), whose collectives move no
   data and return at once.  A step run on DTensors laid out on it is the
   program rank 0 would run, with every collective it would emit; the
   dry-run traces it on ``meta``.
 * ``"gloo"`` / ``"nccl"``: the group of ranks this process joined
   (:func:`repro_torch.distributed.ranks.join`), whose size is the
   mesh's.  Each rank runs its own program on its own shards, and the
   collectives move data.
"""

from __future__ import annotations

import contextlib
import logging
from typing import Iterator

from repro_torch.distributed.sharding import Mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_debug_mesh(shape=(2, 2), axes=("data", "model")) -> Mesh:
    """A small mesh description for the sharding rules' tests."""
    return Mesh(tuple(axes), tuple(shape))


def mesh_axis_sizes(mesh: Mesh) -> dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.shape))


def mesh_name(mesh: Mesh) -> str:
    """``pod16x16`` / ``pod2x16x16`` for the production meshes (the
    reference's names), else ``mesh`` and the shape (``mesh2x2``)."""
    if mesh == make_production_mesh():
        return "pod16x16"
    if mesh == make_production_mesh(multi_pod=True):
        return "pod2x16x16"
    return "mesh" + "x".join(map(str, mesh.shape))


@contextlib.contextmanager
def device_mesh(mesh: Mesh, device_type: str = "cuda",
                backend: str = "fake") -> Iterator:
    """A torch ``DeviceMesh`` of ``mesh``'s shape and axis names.

    ``backend="fake"``: rank 0's, over a ``"fake"`` process group of
    ``mesh.size`` ranks, created on entry and destroyed on exit (the
    process is left with no process group).  ``device_type`` is the
    mesh's: ``"cuda"``, a mesh of GPUs whether the local shards lie on
    the card or on ``meta`` (DTensor then emits an all-to-all where a CPU
    mesh would all-gather and slice); nothing here touches a card.

    ``backend="gloo"`` or ``"nccl"``: this rank's, over the group it
    joined with that backend, which must have ``mesh.size`` ranks; the
    group outlives the block.  On a CUDA mesh over gloo, DTensors may be
    laid out and read (``from_local`` / ``to_local``) but not
    redistributed: DTensor's collectives crash there
    (:mod:`repro_torch.distributed.ranks`)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if backend == "fake":
        # registers the "fake" backend on the torch versions that do not
        import torch.testing._internal.distributed.fake_pg  # noqa: F401
        if dist.is_initialized():
            raise RuntimeError("a process group is already initialized")
        dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                                world_size=mesh.size)
    else:
        from repro_torch.distributed import ranks
        if not ranks.active() or dist.get_backend() != backend:
            raise RuntimeError(f"device_mesh(backend={backend!r}) runs in a "
                               f"rank that joined a {backend} group "
                               f"(distributed.ranks.join)")
        if ranks.world_size() != mesh.size:
            raise ValueError(f"a {mesh.shape} mesh needs {mesh.size} ranks, "
                             f"the group has {ranks.world_size()}")
    # DTensor warns of each two-axis all-reduce it runs as two
    log = logging.getLogger("torch.distributed.tensor")
    level = log.level
    log.setLevel(logging.ERROR)
    try:
        yield init_device_mesh(device_type, mesh.shape,
                               mesh_dim_names=mesh.axis_names)
    finally:
        log.setLevel(level)
        if backend == "fake":
            dist.destroy_process_group()
