"""Mesh construction (the reference's ``repro.launch.mesh``).

The production meshes are the reference's TPU v5e layouts, (data=16,
model=16) for one pod and (pod=2, data=16, model=16) for two: on the port
they are descriptions (a :class:`~repro_torch.distributed.sharding.Mesh`
without devices), which the sharding rules resolve against and which no
single card holds.  In the multi-pod mesh the ``pod`` axis is the
federated-learning client axis (:mod:`repro_torch.distributed.fl_mesh`).
"""

from __future__ import annotations

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
