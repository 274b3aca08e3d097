"""The port over a real group of ranks (``repro_torch.distributed.ranks``):
R processes on the CPU joined in a gloo group, each running its own
program whose collectives move data.

The rank bodies are a script this file writes (:data:`RANK_SCRIPT`); it
starts R processes with ``torch.multiprocessing`` (spawn), which meet in
a ``FileStore`` under ``tmp_path``, with the group's 60 s timeout, under
a subprocess timeout of :data:`LAUNCH_TIMEOUT_S`.  Each launch runs a
group of cases, so the file makes only a few.

* The pod aggregation (``fl_mesh.make_fl_aggregate`` on a stacked tree
  laid out with the pod axis over the ranks), both modes, over P = 2 and
  3 ranks on a ``("pod",)`` mesh and over 4 ranks on a (pod 2, data 1,
  model 2) mesh whose model axis splits the last axis of some leaves:
  every rank's shard bitwise the one-process aggregation's.  Against the
  reference on P forced host devices, ``tests/test_torch_fl_mesh.py``'s
  tree and tolerances: ``exact`` bitwise at P = 2; ``int8`` within one
  ulp of the row's absmax at P = 2 (XLA's CPU backend contracts the
  reference's dequantize into its pod sum), 4 ulp at P = 3.
* ``ShardBackend`` over 2 and 3 ranks at K = 5 (padded to 8 and 9): the
  rows bitwise the one-process vmap's at one intra-op thread; against
  the reference's ``shard`` on as many forced host devices, the
  consensus model within ``assert_ulp_close`` (it is 0 ulp) and the MLP
  (on the reference's threefry draws) within ``rtol=1e-5, atol=1e-6``,
  the port's vmap-against-reference tolerance
  (``test_torch_client_compute.py``): torch's and XLA's CPU matmuls round
  apart, which moves values near zero by many ulp.
* ``fleet_sim --train-backend shard --dist-backend gloo`` under torchrun
  over 2 ranks (12 clients, 1 round): rank 0's round lines equal the
  one-process run's (wall time aside), its output is the only one, and
  the final parameters are equal on both ranks.
* The mesh dry-run's per-rank programs by value
  (``lowering.cell_program`` with a seed and ``backend="gloo"``): on a
  (2, 2) ``("data", "model")`` mesh and a (2, 1, 2) ``("pod", "data",
  "model")`` mesh, smoke configs in float32, yi-9b, olmoe-1b-7b (ragged
  MoE) and xlstm-350m ``train_4k`` steps cut to batch 8 x sequence 32
  (the loss, the updated parameters and AdamW's first moment, one
  tenth of the gradient), and gemma3-12b decode steps over a 64-slot
  cache split under the ``long_500k`` rules (the online-softmax
  combine), at its last slot and at slot 20 (the logits and the written
  cache).  Each ``full_tensor()`` is within
  :data:`PROGRAM_REL_L2` relative L2 of the unsharded step on the same
  seeded global arguments: the shards reduce in other orders (partial
  matmuls, all-reduced sums), so a float32 bound and not bitwise.  The
  xLSTM's gradients are chaotic at its random init (one-ulp weight
  noise moves them by about 1%, ``tests/test_torch_fl_lm.py``), so its
  first moment is held to :data:`XLSTM_GRAD_REL_L2`; AdamW's first
  step is sign-like, so its parameters hold the float32 bound.  The
  ragged MoE drops tokens past an expert's capacity within each dispatch
  group, a device's tokens (as in the reference's ``shard_map``), so a
  sharded step drops other tokens than the unsharded one: its cases run
  at the capacity factor E / K, where no expert can overflow.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

sys.path.insert(0, os.path.dirname(__file__))
from test_client_compute import assert_ulp_close  # noqa: E402
from test_torch_fl_mesh import (LEAVES, ULPS, _ulp, make_tree,  # noqa: E402
                                pod_sums)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH_TIMEOUT_S = 120
PROGRAM_REL_L2 = 1e-5
XLSTM_GRAD_REL_L2 = 1e-2
#: the shard backend's batch (padded to a multiple of the ranks)
SHARD_K = 5
MLP_SMALL = {"n_train": 512, "n_test": 128, "shard_size": 32, "hidden": 16}
#: per-pod leaf -> logical axes on the (pod, data, model) mesh: the model
#: axis ("d_ff", "vocab" under TRAIN_RULES) splits the last axis of "w",
#: "norm" and "proj", and "emb"'s 11 rows unevenly (6 + 5)
MESH_SPECS = {"bias": (None,), "norm": ("d_ff",), "w": (None, "d_ff"),
              "proj": (None, None, "d_ff"), "emb": ("vocab", None)}

RANK_SCRIPT = textwrap.dedent('''
    """Rank bodies: python ranks_body.py CASE WORLD DIR (see
    tests/test_torch_ranks.py).  Writes DIR/<case>.<rank>.npz and
    DIR/<case>.<rank>.json."""
    import json
    import os
    import sys

    import numpy as np
    import torch
    import torch.multiprocessing as mp

    MLP_SMALL = json.loads(os.environ["MLP_SMALL"])


    def _f32(t):
        t = t.detach()
        return (t.float() if t.is_floating_point() else t).numpy()


    def pod_aggregation(out, arrays, mesh_shape, axes, specs, world):
        from repro_torch.distributed import fl_mesh, ranks
        from repro_torch.distributed import sharding as sh
        from repro_torch.launch.mesh import device_mesh
        src = np.load(os.path.join(sys.argv[3], "tree.npz"))
        dtypes = json.loads(os.environ["TREE_DTYPES"])
        tree = {k: torch.from_numpy(src[k]).to(getattr(torch, dtypes[k]))
                for k in dtypes}
        mesh = sh.Mesh(tuple(axes), tuple(mesh_shape))
        rules = dict(sh.TRAIN_RULES, fl_pod="pod")
        with device_mesh(mesh, "cpu", "gloo") as dm, \\
                sh.use_mesh(mesh, rules, dm):
            stacked = sh.shard_tree(tree, fl_mesh.stacked_specs(
                {k: tuple(v) for k, v in specs.items()}))
            for mode in fl_mesh.MODES:
                traffic = ranks.Traffic()
                got = fl_mesh.make_fl_aggregate(
                    mesh, mode=mode, traffic=traffic)(stacked)
                want = fl_mesh.make_fl_aggregate(mesh, mode=mode)(tree)
                for k, x in got.items():
                    assert x.shape == tree[k].shape
                    arrays[f"got/{mode}/{k}"] = _f32(x.to_local())
                    arrays[f"want/{mode}/{k}"] = _f32(sh.take_shard(
                        want[k], x.placements, dm))
                out[f"traffic/{mode}"] = [traffic.sent, traffic.received,
                                          dict(traffic.calls)]


    def shard_backend(out, arrays, world):
        from repro_torch import device as port_device
        from repro_torch.core.client_compute import (make_model,
                                                     make_train_backend)
        from repro_torch.core.packetizer import flatten_to_vector
        from repro_torch.distributed import fl_mesh
        from repro_torch.models import mlp as port_mlp

        def threefry(seed, client, round_idx, step, n, shard_len, device):
            import jax
            key = jax.random.fold_in(jax.random.fold_in(
                jax.random.PRNGKey(seed), client), round_idx)
            pick = jax.random.randint(jax.random.fold_in(key, step), (n,),
                                      0, shard_len)
            return torch.from_numpy(np.asarray(pick).astype(np.int64))
        port_mlp.minibatch_indices = threefry
        assert fl_mesh.client_mesh().size == world
        k = int(os.environ["SHARD_K"])
        with port_device.use_device("cpu"):
            for name, kw in (("consensus", {"n_params": 96}),
                             ("mlp", MLP_SMALL)):
                model = make_model(name, 8, seed=0, **kw)
                vec0 = flatten_to_vector(model.init_params())
                rng = np.random.default_rng(7)
                stack = (vec0[None] + 0.01 * rng.standard_normal(
                    (k, vec0.size))).astype(np.float32)
                ci = np.arange(k, dtype=np.int32)
                ri = np.asarray([0, 1, 2, 3, 0][:k], np.int32)
                got, met = make_train_backend("shard").train(
                    model, stack, ci, ri)
                want, wmet = make_train_backend("vmap").train(
                    model, stack, ci, ri)
                arrays[f"shard/{name}"] = got
                arrays[f"vmap/{name}"] = want
                arrays[f"stack/{name}"] = stack
                out[f"metrics/{name}"] = [met, wmet]


    def rel_l2(got, want):
        g = torch.cat([t.detach().double().reshape(-1) for t in got])
        w = torch.cat([t.detach().double().reshape(-1) for t in want])
        return float((g - w).norm() / w.norm())


    def program(out, arch, shape, mesh_shape, axes, moe_impl="scan",
                pos=None):
        from repro_torch.configs import get_config, smoke_variant
        from repro_torch.configs.base import ShapeConfig, TrainConfig
        from repro_torch.distributed import sharding as sh
        from repro_torch.launch import lowering
        from repro_torch.models import transformer
        from repro_torch.tree import tree_leaves, tree_map
        cfg = smoke_variant(get_config(arch))
        shape = ShapeConfig(*shape)
        tc = TrainConfig(grad_accum=1, moe_impl=moe_impl)
        saved = transformer.MOE_CAPACITY_FACTOR
        if moe_impl == "ragged":     # no expert can overflow
            transformer.MOE_CAPACITY_FACTOR = (cfg.num_experts
                                               / cfg.num_experts_per_tok)

        def run(**mesh):
            with lowering.cell_program(arch, shape, cfg=cfg, train_cfg=tc,
                                       device_type="cpu", seed=0,
                                       **mesh) as (step, args, _):
                if pos is not None:
                    args = (args[0], dict(args[1], pos=pos)) + args[2:]
                grad = (torch.enable_grad if shape.mode == "train"
                        else torch.no_grad)
                with grad():
                    res = step(*args)
                return tree_map(lambda x: x.full_tensor()
                                if sh.is_distributed(x) else x, res)
        try:
            mesh = sh.Mesh(tuple(axes), tuple(mesh_shape))
            got = run(mesh=mesh, backend="gloo")
            want = run()
        finally:
            transformer.MOE_CAPACITY_FACTOR = saved
        tag = f"{arch}/{shape.mode}/{'x'.join(map(str, mesh_shape))}"
        if pos is not None:
            tag += f"/pos{pos}"
        if shape.mode == "train":
            (gs, gm), (ws, wm) = got, want
            out[tag] = {
                "loss": rel_l2([gm["loss"]], [wm["loss"]]),
                "params": rel_l2(tree_leaves(gs.params),
                                 tree_leaves(ws.params)),
                "grads": rel_l2(tree_leaves(gs.opt_state["m"]),
                                tree_leaves(ws.opt_state["m"]))}
        else:
            (gl, gc), (wl, wc) = got, want
            out[tag] = {"logits": rel_l2([gl], [wl]),
                        "cache": rel_l2([gc["k"], gc["v"]],
                                        [wc["k"], wc["v"]])}


    TRAIN = ("train_4k", 32, 8, "train")
    DECODE = ("long_500k", 1, 1, "decode", 64)
    DM = ((2, 2), ("data", "model"))
    PDM = ((2, 1, 2), ("pod", "data", "model"))


    def programs(out, mesh, which):
        for arch, shape, kw in (
                ("yi-9b", TRAIN, {}),
                ("olmoe-1b-7b", TRAIN, {"moe_impl": "ragged"}),
                ("xlstm-350m", TRAIN, {}),
                ("gemma3-12b", DECODE, {}),
                ("gemma3-12b", DECODE, {"pos": 20})):
            if arch in which:
                program(out, arch, shape, *mesh, **kw)


    def body(rank, world, case, dirname):
        from repro_torch.distributed import ranks
        torch.set_num_threads(1)
        ranks.join("gloo", device_type="cpu", rank=rank, world_size=world,
                   store_path=os.path.join(dirname, case + ".store"))
        out, arrays = {}, {}
        try:
            if case == "pods":
                pod_aggregation(out, arrays, (world,), ("pod",),
                                {k: [None] * (len(v) - 1) for k, v in
                                 json.loads(os.environ["TREE_SHAPES"])
                                 .items()}, world)
                shard_backend(out, arrays, world)
            elif case == "mesh":
                pod_aggregation(out, arrays, *PDM,
                                json.loads(os.environ["MESH_SPECS"]), world)
                programs(out, DM, ("yi-9b", "olmoe-1b-7b", "xlstm-350m",
                                   "gemma3-12b"))
            elif case == "pod_train":
                programs(out, PDM, ("yi-9b", "olmoe-1b-7b"))
            elif case == "pod_rest":
                programs(out, PDM, ("xlstm-350m", "gemma3-12b"))
        finally:
            ranks.leave()
        np.savez(os.path.join(dirname, f"{case}.{rank}.npz"), **arrays)
        with open(os.path.join(dirname, f"{case}.{rank}.json"), "w") as f:
            json.dump(out, f)


    if __name__ == "__main__":
        case, world, dirname = sys.argv[1], int(sys.argv[2]), sys.argv[3]
        mp.start_processes(body, args=(world, case, dirname), nprocs=world,
                           start_method="spawn")
        print("OK")
''')

_REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ['XLA_FLAGS'] = (
        '--xla_force_host_platform_device_count=' + sys.argv[1])
    import json
    import jax, jax.numpy as jnp, numpy as np
    from repro.core.client_compute import make_model, make_train_backend
    from repro.core.packetizer import flatten_to_vector
    from repro.distributed import fl_mesh as F
    pods = int(sys.argv[1])
    src = np.load(sys.argv[2])
    tree = {k: jnp.asarray(src[k]).astype(src['dtype_' + k].item())
            for k in src.files if not k.startswith('dtype_')}
    mesh = jax.make_mesh((pods,), ('pod',))
    out = {}
    for mode in ('exact', 'int8'):
        agg = jax.jit(F.make_fl_aggregate(mesh, mode=mode))
        for k, v in agg(tree).items():
            out[mode + '/' + k] = np.asarray(v.astype(jnp.float32))
    assert jax.device_count() == pods
    k = int(sys.argv[4])
    for name, kw in (('consensus', {'n_params': 96}),
                     ('mlp', json.loads(sys.argv[5]))):
        model = make_model(name, 8, seed=0, **kw)
        vec0 = flatten_to_vector(model.init_params())
        rng = np.random.default_rng(7)
        stack = (vec0[None] + 0.01 * rng.standard_normal(
            (k, vec0.size))).astype(np.float32)
        ci = np.arange(k, dtype=np.int32)
        ri = np.asarray([0, 1, 2, 3, 0][:k], np.int32)
        got, _ = make_train_backend('shard').train(model, stack, ci, ri)
        out['shard/' + name] = got
    np.savez(sys.argv[3], **out)
    print('OK')
""")


def _env(**extra) -> dict:
    return {"PYTHONPATH": "src", "PATH": os.environ.get("PATH",
                                                      "/usr/bin:/bin"),
            "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1",
            "MLP_SMALL": json.dumps(MLP_SMALL), "SHARD_K": str(SHARD_K),
            **extra}


def launch(tmp_path, case: str, world: int, **env) -> list[tuple]:
    """Run ``case`` over ``world`` ranks; per rank its (json, arrays)."""
    script = tmp_path / "ranks_body.py"
    script.write_text(RANK_SCRIPT)
    r = subprocess.run([sys.executable, str(script), case, str(world),
                        str(tmp_path)], capture_output=True, text=True,
                       timeout=LAUNCH_TIMEOUT_S, cwd=ROOT, env=_env(**env))
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-3000:]
    out = []
    for rank in range(world):
        with open(tmp_path / f"{case}.{rank}.json") as f:
            rec = json.load(f)
        with np.load(tmp_path / f"{case}.{rank}.npz") as f:
            out.append((rec, dict(f)))
    return out


def write_tree(tmp_path, tree: dict) -> dict:
    np.savez(tmp_path / "tree.npz", **tree)
    return {"TREE_DTYPES": json.dumps({k: LEAVES[k][1] for k in tree}),
            "TREE_SHAPES": json.dumps({k: list(v.shape)
                                       for k, v in tree.items()})}


def reference(tmp_path, pods: int, tree: dict) -> dict:
    src, dst = tmp_path / "ref_tree.npz", tmp_path / "ref.npz"
    np.savez(src, **tree, **{"dtype_" + k: np.array(LEAVES[k][1])
                             for k in tree})
    r = subprocess.run([sys.executable, "-c", _REFERENCE, str(pods),
                        str(src), str(dst), str(SHARD_K),
                        json.dumps(MLP_SMALL)], capture_output=True,
                       text=True, timeout=600, cwd=ROOT,
                       env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin",
                            "JAX_PLATFORMS": "cpu"})
    assert "OK" in r.stdout, r.stderr[-2000:]
    with np.load(dst) as f:
        return dict(f)


def _bits(x: np.ndarray) -> np.ndarray:
    return x.view(np.int32)


def _hold_bitwise_shards(per_rank) -> None:
    for rank, (_, arrays) in enumerate(per_rank):
        got = sorted(k for k in arrays if k.startswith("got/"))
        assert len(got) == 2 * len(LEAVES)
        for key in got:
            want = arrays["want/" + key[4:]]
            assert np.array_equal(_bits(arrays[key]), _bits(want)), \
                (rank, key)


@pytest.mark.parametrize("pods", [2, 3])
def test_pod_aggregation_and_shard_backend_over_ranks(tmp_path, pods):
    tree = make_tree(pods, seed=pods)
    per_rank = launch(tmp_path, "pods", pods, **write_tree(tmp_path, tree))
    # every rank's shard: bitwise the one-process aggregation's
    _hold_bitwise_shards(per_rank)
    # ... and it is its pod's row of the reference's aggregation
    want = reference(tmp_path, pods, tree)
    for rank, (rec, arrays) in enumerate(per_rank):
        for mode in ("exact", "int8"):
            for name, (shape, dtype) in LEAVES.items():
                g = arrays[f"got/{mode}/{name}"][0]
                w = want[f"{mode}/{name}"][rank]
                if pods == 2 and mode == "exact":
                    assert np.array_equal(_bits(g), _bits(w)), (mode, name)
                    continue
                if pods == 2:
                    unfused, _ = pod_sums(tree[name], dtype)
                    assert np.array_equal(_bits(g), _bits(unfused))
                absmax = np.abs(tree[name]).max(axis=(0, -1), keepdims=True)
                tol = (1 if pods == 2 else ULPS) * _ulp(absmax[0], dtype)
                assert (np.abs(g - w) <= tol).all(), (mode, name)
            # the bytes this rank sent: its pod's rows to the P - 1 others
            sent, received, calls = rec[f"traffic/{mode}"]
            per_pod = (sum(int(np.prod(s)) * (2 if d == "bfloat16" else 4)
                           for s, d in LEAVES.values()) if mode == "exact"
                       else sum(int(np.prod(s)) + 4 * int(np.prod(s[:-1]))
                                for s, _ in LEAVES.values()))
            assert sent == received == per_pod * (pods - 1), mode
            assert calls == {"all_gather": len(LEAVES) * (1 if mode ==
                                                           "exact" else 2)}
    # the shard backend: every rank returns the same rows, bitwise the
    # one-process vmap's, within the reference's shard bounds
    for name in ("consensus", "mlp"):
        rows = [arrays[f"shard/{name}"] for _, arrays in per_rank]
        assert rows[0].shape[0] == SHARD_K
        for r, (rec, arrays) in enumerate(per_rank):
            assert np.array_equal(_bits(rows[r]),
                                  _bits(arrays[f"vmap/{name}"])), (name, r)
            met, vmet = rec[f"metrics/{name}"]
            assert met == vmet
        if name == "consensus":
            assert_ulp_close(rows[0], want[f"shard/{name}"])
        else:
            np.testing.assert_allclose(rows[0], want[f"shard/{name}"],
                                       rtol=1e-5, atol=1e-6)


def _hold_programs(per_rank, n_cases: int) -> None:
    for rank, (rec, _) in enumerate(per_rank):
        tags = [t for t in rec if not t.startswith("traffic/")]
        assert len(tags) == n_cases, tags
        for tag in tags:
            for what, err in rec[tag].items():
                bound = (XLSTM_GRAD_REL_L2 if tag.startswith("xlstm")
                         and what == "grads" else PROGRAM_REL_L2)
                assert err <= bound, (rank, tag, what, err)


def test_pod_aggregation_on_a_model_split_mesh_and_programs_on_2x2(
        tmp_path):
    """4 ranks: the pod aggregation on (pod 2, data 1, model 2) with leaves
    the model axis splits (their rows' absmax all-reduced), and the
    sharded train and decode steps on a (2, 2) data x model mesh."""
    tree = make_tree(2, seed=5)
    per_rank = launch(tmp_path, "mesh", 4, MESH_SPECS=json.dumps(MESH_SPECS),
                      **write_tree(tmp_path, tree))
    _hold_bitwise_shards(per_rank)
    for rec, _ in per_rank:
        # the absmax all-reduce ran for the three leaves the model axis
        # splits along their last axis
        assert rec["traffic/int8"][2] == {"all_gather": 2 * len(LEAVES),
                                          "all_reduce": 3}
    _hold_programs(per_rank, 5)


@pytest.mark.parametrize("case", ["pod_train", "pod_rest"])
def test_programs_on_the_pod_mesh(tmp_path, case):
    """The sharded steps on the (2, 1, 2) pod x data x model mesh (two
    launches: DTensor's sharding propagation on a 3-axis mesh is slow on
    the CPU)."""
    per_rank = launch(tmp_path, case, 4)
    _hold_programs(per_rank, 2 if case == "pod_train" else 3)


def _round_lines(text: str) -> list[str]:
    return [line.rsplit(" | wall", 1)[0] for line in text.splitlines()
            if line.startswith(("round ", "===", "    [", "-->"))]


def test_fleet_sim_shard_backend_under_torchrun(tmp_path):
    args = ["--device", "cpu", "--model", "mlp", "--train-backend",
            "shard", "--mode", "sync", "--transport", "mudp", "--clients",
            "12", "--rounds", "1"]
    env = _env()
    two = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.fleet_sim", *args,
         "--dist-backend", "gloo", "--out", str(tmp_path / "two.json")],
        capture_output=True, text=True, timeout=LAUNCH_TIMEOUT_S, cwd=ROOT,
        env=env)
    assert two.returncode == 0, two.stderr[-3000:]
    one = subprocess.run(
        [sys.executable, "-m", "repro_torch.fleet_sim", *args, "--out",
         str(tmp_path / "one.json")], capture_output=True, text=True,
        timeout=LAUNCH_TIMEOUT_S, cwd=ROOT, env=env)
    assert one.returncode == 0, one.stderr[-3000:]
    lines = _round_lines(two.stdout)
    # rank 0 alone printed, and the ranks ended equal
    assert sum(line.startswith("===") for line in lines) == 1
    assert lines[-1].startswith("    [gloo] final global parameters "
                                "bitwise equal on 2 ranks")
    assert lines[:-1] == _round_lines(one.stdout)
    with open(tmp_path / "two.json") as f:
        got = json.load(f)
    with open(tmp_path / "one.json") as f:
        want = json.load(f)
    assert got["ranks"] == 2 and want["ranks"] == 1
    assert got["arms"] == want["arms"]


def test_backends_are_explicit_and_nccl_needs_a_card_a_rank(monkeypatch):
    from repro_torch.distributed import ranks
    from repro_torch.launch import lowering
    from repro_torch.launch.mesh import device_mesh, make_debug_mesh
    with pytest.raises(ValueError, match="one of"):
        ranks.join("fake", rank=0, world_size=1)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="nccl needs a card a rank"):
        ranks.join("nccl", device_type="cuda", rank=0, world_size=2)
    with pytest.raises(RuntimeError, match="nccl runs on cards"):
        ranks.join("nccl", device_type="cpu", rank=0, world_size=1)
    assert not ranks.active() and ranks.world_size() == 1
    with pytest.raises(RuntimeError, match="joined a gloo group"):
        with device_mesh(make_debug_mesh(), "cpu", "gloo"):
            pass
    with pytest.raises(RuntimeError, match="CUDA mesh over gloo"):
        with lowering.cell_program("yi-9b", "train_4k",
                                   mesh=make_debug_mesh(), backend="gloo",
                                   seed=0):
            pass
    with pytest.raises(ValueError, match="seed="):
        with lowering.cell_program("yi-9b", "train_4k", backend="gloo",
                                   mesh=make_debug_mesh(), device_type="cpu"):
            pass
