"""The port's sharding rules and mesh tooling against the reference's.

* ``rules_for`` gives the reference's dict for every architecture x shape
  x mesh shape in {(16, 16), (2, 16, 16), (2, 2), (2, 2, 2)}.  The
  reference's side gets a stand-in mesh with ``axis_names`` and
  ``devices.shape``, all its ``rules_for`` and ``logical_spec`` read, so
  no devices are needed.
* ``logical_spec`` under ``use_mesh`` gives the entries of the
  reference's ``PartitionSpec`` for every spec tree of every cell.
* The override dicts, the skip policy and the production meshes are the
  reference's; on one card ``constraint`` is the identity, and the
  ``shard`` train backend runs as ``vmap`` on one device and raises with
  more than one visible card.

Tolerance: none, every comparison is equality.
"""

from __future__ import annotations

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import ARCH_IDS, SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.distributed import sharding as rsh  # noqa: E402
from repro.launch import lowering as rlow  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.distributed import sharding as psh  # noqa: E402
from repro_torch.launch import lowering as plow  # noqa: E402
from repro_torch.launch import mesh as pmesh  # noqa: E402
from repro_torch.models import model as PM  # noqa: E402

MESHES = {(16, 16): ("data", "model"), (2, 16, 16): ("pod", "data", "model"),
          (2, 2): ("data", "model"), (2, 2, 2): ("pod", "data", "model")}


def ref_mesh(shape):
    return types.SimpleNamespace(axis_names=MESHES[shape],
                                 devices=np.empty(shape, dtype=np.int8))


def port_mesh(shape):
    return psh.Mesh(MESHES[shape], shape)


def _spec_leaves(tree):
    if rsh._is_spec_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _spec_leaves(tree[k])]
    return [s for v in tree for s in _spec_leaves(v)]


@pytest.mark.parametrize("mesh_shape", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_rules_for_equals_the_reference(arch, mesh_shape):
    for shape in REF_SHAPES:
        want = rsh.rules_for(ref_config(arch), REF_SHAPES[shape],
                             ref_mesh(mesh_shape))
        got = psh.rules_for(get_config(arch), SHAPES[shape],
                            port_mesh(mesh_shape))
        assert got == want, (arch, shape, mesh_shape)


@pytest.mark.parametrize("mesh_shape", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_logical_spec_equals_the_reference(arch, mesh_shape):
    ref_cfg, cfg = ref_config(arch), get_config(arch)
    for shape in REF_SHAPES:
        trees = (RM.param_specs(ref_cfg), RM.cache_specs(ref_cfg),
                 RM.batch_specs(ref_cfg, REF_SHAPES[shape]))
        specs = [s for t in trees for s in _spec_leaves(t)]
        rules_r = rsh.rules_for(ref_cfg, REF_SHAPES[shape],
                                ref_mesh(mesh_shape))
        rules_p = psh.rules_for(cfg, SHAPES[shape], port_mesh(mesh_shape))
        with rsh.use_mesh(ref_mesh(mesh_shape), rules_r):
            want = [tuple(rsh.logical_spec(*s)) for s in specs]
        with psh.use_mesh(port_mesh(mesh_shape), rules_p):
            got = [psh.logical_spec(*s) for s in specs]
            assert psh.active_mesh() == port_mesh(mesh_shape)
        assert got == want, (arch, shape, mesh_shape)
    assert psh.active_mesh() is None


def test_logical_spec_without_a_mesh_replicates():
    assert psh.logical_spec("batch", None, "heads") == (None, None, None)
    assert tuple(rsh.logical_spec("batch", None, "heads")) == \
        psh.logical_spec("batch", None, "heads")


def test_tree_shardings_and_constraint():
    specs = PM.param_specs(get_config("hymba-1.5b"))
    with pytest.raises(RuntimeError):
        psh.tree_shardings(specs)
    mesh = port_mesh((2, 16, 16))
    rules = psh.rules_for(get_config("hymba-1.5b"), SHAPES["train_4k"], mesh)
    with psh.use_mesh(mesh, rules):
        tree = psh.tree_shardings(specs)
        assert psh.named_sharding("batch") == psh.NamedSharding(
            mesh, (("pod", "data"),))
    assert tree["layers"]["ssm"]["w_dt"] == psh.NamedSharding(
        mesh, (None, "data", None))     # d_inner 1600 % 16 != 0
    assert tree["embed"].spec == ("model", "data")
    assert psh.named_sharding("batch") is None
    x = torch.ones(3)
    assert psh.constraint(x, "batch") is x


def test_override_dicts_and_skip_policy_equal_the_reference():
    assert plow.CELL_TRAIN_OVERRIDES == rlow.CELL_TRAIN_OVERRIDES
    assert plow.CELL_RULES_OVERRIDES == rlow.CELL_RULES_OVERRIDES
    assert plow.LONG_CONTEXT_OK == rlow.LONG_CONTEXT_OK
    for arch in ARCH_IDS:
        for shape in REF_SHAPES:
            assert plow.cell_is_skipped(arch, shape) == \
                rlow.cell_is_skipped(arch, shape)
            assert plow.shape_applicable(get_config(arch), shape) == \
                rlow.shape_applicable(ref_config(arch), shape)


def test_production_and_debug_meshes():
    one = pmesh.make_production_mesh()
    two = pmesh.make_production_mesh(multi_pod=True)
    assert pmesh.mesh_axis_sizes(one) == {"data": 16, "model": 16}
    assert pmesh.mesh_axis_sizes(two) == {"pod": 2, "data": 16, "model": 16}
    assert one.devices is None and two.size == 512
    assert pmesh.mesh_axis_sizes(pmesh.make_debug_mesh()) == \
        {"data": 2, "model": 2}
    with pytest.raises(ValueError):
        psh.Mesh(("data",), (2,), (torch.device("cpu"),))


def test_shard_backend_is_vmap_on_one_device_and_refuses_several(
        monkeypatch):
    from repro_torch.core import client_compute as cc
    from repro_torch.distributed import fl_mesh
    from repro_torch.models.mlp import MnistMLPModel

    model = MnistMLPModel(2, hidden=8, local_steps=1, batch_size=4,
                          n_train=256, n_test=64, shard_size=64,
                          device="cpu")
    rng = np.random.default_rng(0)
    stack = rng.standard_normal((2, model.n_params)).astype(np.float32)
    idx, rnd = np.array([0, 1]), np.array([0, 0])
    shard = cc.make_train_backend("shard")
    vmap = cc.make_train_backend("vmap")
    assert fl_mesh.client_mesh().size == max(1, torch.cuda.device_count())
    got, _ = shard.train(model, stack, idx, rnd)
    want, _ = vmap.train(model, stack, idx, rnd)
    np.testing.assert_array_equal(got, want)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert fl_mesh.client_mesh().shape == (2,)
    with pytest.raises(NotImplementedError, match="several cards"):
        shard.train(model, stack, idx, rnd)
