"""The port's checkpoint layer against the reference's.

Mirrors of ``tests/test_checkpoint.py`` (container round trips, retention,
journal replay, crash-restart over a real system) and of the checkpoint
and journal cases of ``tests/test_substrate.py``, on trees of tensors;
then the two packages against each other: a file written by either loads
in the other, and the same tree with the same metadata and codec writes
the same bytes (``TrainState`` and bfloat16 leaves included).  Every
comparison is exact: a checkpoint stores raw bytes.
"""

from __future__ import annotations

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import checkpointer as ref_ckpt  # noqa: E402
from repro.optim import TrainState as RefTrainState  # noqa: E402
from repro_torch import device as port_device  # noqa: E402
from repro_torch.checkpoint import (CheckpointManager, FLJournal,  # noqa: E402
                                    load_pytree, save_pytree)
from repro_torch.checkpoint import checkpointer as port_ckpt  # noqa: E402
from repro_torch.optim import TrainState  # noqa: E402
from repro_torch.tree import named_leaves  # noqa: E402


@pytest.fixture(autouse=True)
def _cpu():
    with port_device.use_device("cpu"):
        yield


def tree_equal(a, b) -> bool:
    if isinstance(a, dict):
        return (set(a) == set(b)
                and all(tree_equal(a[k], b[k]) for k in a))
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
                and a.dtype == b.dtype and torch.equal(a, b))
    return (np.asarray(a).dtype == np.asarray(b).dtype
            and np.array_equal(np.asarray(a), np.asarray(b)))


@pytest.fixture
def tree():
    return {
        "layer0": {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
                   "b": torch.full((4,), -1.5)},
        "head": torch.arange(7, dtype=torch.int32),
    }


# --------------------------------------------------------------------------
# Container round-trips (tests/test_checkpoint.py)
# --------------------------------------------------------------------------
def test_roundtrip_without_template(tmp_path, tree):
    p = str(tmp_path / "a.ckpt")
    save_pytree(p, tree, {"round": 5, "note": "x"})
    out, meta = load_pytree(p)
    assert meta == {"round": 5, "note": "x"}
    assert tree_equal(out, tree)


def test_roundtrip_with_template_preserves_structure(tmp_path, tree):
    p = str(tmp_path / "a.ckpt")
    save_pytree(p, tree)
    out, meta = load_pytree(p, template=tree)
    assert meta == {}
    assert tree_equal(out, tree)


def test_template_shape_mismatch_raises(tmp_path, tree):
    p = str(tmp_path / "a.ckpt")
    save_pytree(p, tree)
    bad = {**tree, "head": torch.zeros(9, dtype=torch.int32)}
    with pytest.raises(ValueError, match="shape"):
        load_pytree(p, template=bad)


def test_template_missing_leaf_raises(tmp_path, tree):
    p = str(tmp_path / "a.ckpt")
    save_pytree(p, tree)
    bigger = {**tree, "extra": torch.zeros(2)}
    with pytest.raises(KeyError, match="extra"):
        load_pytree(p, template=bigger)


def test_not_a_checkpoint_raises(tmp_path):
    p = str(tmp_path / "junk.ckpt")
    with open(p, "wb") as f:
        f.write(b"definitely not a checkpoint")
    with pytest.raises(ValueError, match="magic|truncated"):
        load_pytree(p)


def test_atomic_write_leaves_no_tmp(tmp_path, tree):
    p = str(tmp_path / "a.ckpt")
    save_pytree(p, tree)
    assert not os.path.exists(p + ".tmp")


def test_zlib_codec_always_roundtrips():
    raw = np.arange(1000, dtype=np.float32).tobytes()
    assert port_ckpt._decompress(
        port_ckpt._CODEC_ZLIB,
        port_ckpt._compress(port_ckpt._CODEC_ZLIB, raw)) == raw


def test_zstd_file_without_zstandard_names_the_gap(tmp_path, tree,
                                                   monkeypatch):
    monkeypatch.setattr(port_ckpt, "_zstd", None)
    with pytest.raises(RuntimeError, match="zstandard"):
        port_ckpt._decompress(port_ckpt._CODEC_ZSTD, b"\x28\xb5\x2f\xfd")


# --------------------------------------------------------------------------
# Manager: step indexing + retention
# --------------------------------------------------------------------------
def test_manager_retention_and_latest(tmp_path, tree):
    m = CheckpointManager(str(tmp_path / "ckpts"), keep=2)
    for step in (1, 2, 3, 4):
        m.save(step, tree, {"x": step})
    assert m.steps() == [3, 4]
    assert m.latest_step() == 4
    out, meta = m.restore(tree)
    assert meta["step"] == 4 and meta["x"] == 4
    assert tree_equal(out, tree)
    out3, meta3 = m.restore(tree, step=3)
    assert meta3["step"] == 3


def test_manager_empty_dir_raises(tmp_path, tree):
    m = CheckpointManager(str(tmp_path / "empty"))
    with pytest.raises(FileNotFoundError):
        m.restore(tree)


# --------------------------------------------------------------------------
# Journal: replay bookkeeping
# --------------------------------------------------------------------------
def test_journal_resume_and_pending(tmp_path):
    j = FLJournal(str(tmp_path / "j.log"))
    assert j.resume_round() == 0 and j.pending_clients() == []
    j.round_started(0, ["a", "b", "c"])
    j.update_ingested(0, "a")
    j.round_finalized(0, "ckpt_0", arrived=["a"], failed=["b", "c"])
    j.round_started(1, ["a", "b"])
    j.update_ingested(1, "b")
    j2 = FLJournal(str(tmp_path / "j.log"))   # reload from disk
    assert j2.last_finalized_round() == 0
    assert j2.last_checkpoint() == "ckpt_0"
    assert j2.resume_round() == 1
    assert j2.pending_clients() == ["a"]      # b already ingested


def test_journal_resume_round_after_crash(tmp_path):
    p = str(tmp_path / "journal.jsonl")
    j = FLJournal(p)
    j.round_started(0, ["c1", "c2"])
    j.update_ingested(0, "c1")
    j.update_ingested(0, "c2")
    j.round_finalized(0, "ckpt_0", ["c1", "c2"], [])
    j.round_started(1, ["c1", "c2"])
    j.update_ingested(1, "c1")
    j2 = FLJournal(p)
    assert j2.last_finalized_round() == 0
    assert j2.resume_round() == 1
    assert j2.pending_clients() == ["c2"]
    assert j2.last_checkpoint() == "ckpt_0"


def test_fresh_journal(tmp_path):
    j = FLJournal(str(tmp_path / "j.jsonl"))
    assert j.resume_round() == 0
    assert j.pending_clients() == []


def test_journal_files_are_the_references(tmp_path):
    from repro.checkpoint import FLJournal as RefJournal
    for cls, name in ((FLJournal, "port"), (RefJournal, "ref")):
        j = cls(str(tmp_path / f"{name}.jsonl"))
        j.round_started(0, ["a", "b"])
        j.update_ingested(0, "b")
        j.round_finalized(0, "ckpt_0", ["b"], ["a"])
    assert ((tmp_path / "port.jsonl").read_bytes()
            == (tmp_path / "ref.jsonl").read_bytes())


# --------------------------------------------------------------------------
# The substrate cases (tests/test_substrate.py::TestCheckpoint), bf16 too
# --------------------------------------------------------------------------
def _substrate_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": torch.from_numpy(
                rng.standard_normal((4, 5)).astype(np.float32)),
            "nested": {"b": torch.from_numpy(
                           rng.integers(0, 10, (3,)).astype(np.int32)),
                       "c": torch.from_numpy(rng.standard_normal(
                           (2, 2)).astype(np.float32)).to(torch.bfloat16)}}


def test_substrate_roundtrip_keeps_bf16(tmp_path):
    tree = _substrate_tree()
    p = str(tmp_path / "x.ckpt")
    save_pytree(p, tree, {"round": 7})
    out, meta = load_pytree(p, tree)
    assert meta["round"] == 7
    assert tree_equal(out, tree)
    assert out["nested"]["c"].dtype == torch.bfloat16


def test_substrate_shape_mismatch_rejected(tmp_path):
    p = str(tmp_path / "x.ckpt")
    save_pytree(p, _substrate_tree(), {})
    bad = _substrate_tree()
    bad["a"] = torch.zeros((9, 9))
    with pytest.raises(ValueError):
        load_pytree(p, bad)


def test_substrate_manager_restore_specific_step(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=5)
    for s in (1, 2):
        mgr.save(s, _substrate_tree(s))
    out, meta = mgr.restore(_substrate_tree(), step=1)
    assert meta["step"] == 1
    assert tree_equal(out, _substrate_tree(1))


# --------------------------------------------------------------------------
# The two packages' files
# --------------------------------------------------------------------------
def _both_trees(seed=0):
    """The same TrainState in both packages: f32, int32, bf16 leaves, a
    list, and a ``None`` (an empty subtree in both)."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((3, 4)).astype(np.float32)
    c = rng.standard_normal((2, 5)).astype(np.float32)
    ref = RefTrainState(
        jnp.asarray(3, jnp.int32),
        {"w": w, "zeta": {"c": jnp.asarray(c, jnp.bfloat16)},
         "lst": [np.arange(4, dtype=np.int32), np.ones(2, np.float32)]},
        {"m": {"w": w * 2}, "skip": None})
    port = TrainState(
        torch.tensor(3, dtype=torch.int32),
        {"w": torch.from_numpy(w),
         "zeta": {"c": torch.from_numpy(c).to(torch.bfloat16)},
         "lst": [torch.arange(4, dtype=torch.int32), torch.ones(2)]},
        {"m": {"w": torch.from_numpy(w * 2)}, "skip": None})
    return ref, port


@pytest.mark.parametrize("codec", ["zlib", "zstd"])
def test_same_tree_writes_the_same_bytes(tmp_path, codec, monkeypatch):
    if codec == "zlib":
        monkeypatch.setattr(ref_ckpt, "_zstd", None)
        monkeypatch.setattr(port_ckpt, "_zstd", None)
    else:
        pytest.importorskip("zstandard")
    ref, port = _both_trees()
    ref_ckpt.save_pytree(str(tmp_path / "r.ckpt"), ref, {"round": 4})
    save_pytree(str(tmp_path / "p.ckpt"), port, {"round": 4})
    want = (tmp_path / "r.ckpt").read_bytes()
    assert want[5] == (0 if codec == "zlib" else 1)      # the codec byte
    assert (tmp_path / "p.ckpt").read_bytes() == want


def test_reference_file_loads_in_the_port(tmp_path):
    ref, port = _both_trees(1)
    p = str(tmp_path / "r.ckpt")
    ref_ckpt.save_pytree(p, ref, {"arch": "x"})
    out, meta = load_pytree(p, port)
    assert meta == {"arch": "x"} and isinstance(out, TrainState)
    assert torch.equal(out.step, port.step)
    for a, b in zip(named_leaves(out), named_leaves(port)):
        assert a[0] == b[0] and a[1].dtype == b[1].dtype
        assert torch.equal(a[1], b[1])
    flat, _ = load_pytree(p, device="cpu")
    assert torch.equal(flat["params"]["zeta"]["c"], port.params["zeta"]["c"])
    assert torch.equal(flat["opt_state"]["m"]["w"], port.opt_state["m"]["w"])


def test_port_file_loads_in_the_reference(tmp_path):
    ref, port = _both_trees(2)
    p = str(tmp_path / "p.ckpt")
    save_pytree(p, port, {"arch": "y"})
    out, meta = ref_ckpt.load_pytree(p, ref)
    assert meta == {"arch": "y"}
    for a, b in zip(jax.tree_util.tree_leaves(out),
                    jax.tree_util.tree_leaves(ref)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_numpy_template_restores_numpy(tmp_path):
    params = {"w": np.arange(5, dtype=np.float32)}
    p = str(tmp_path / "n.ckpt")
    save_pytree(p, params)
    out, _ = load_pytree(p, params)
    assert isinstance(out["w"], np.ndarray)
    np.testing.assert_array_equal(out["w"], params["w"])


# --------------------------------------------------------------------------
# Integration: snapshot/restore + journal replay over a real system
# --------------------------------------------------------------------------
def _digest(params) -> bytes:
    return np.asarray(params["w"], np.float32).tobytes()


def test_crash_restart_resumes_bitwise(tmp_path):
    from repro_torch.core.fleet import (ConsensusObjective, FleetConfig,
                                        build_fleet)
    from repro_torch.core.rounds import FLConfig, TransportConfig

    def fresh():
        obj = ConsensusObjective(8, 32, seed=11)
        fleet = FleetConfig(n_clients=8, seed=5)
        return obj, build_fleet(
            fleet, obj.init_params(), lambda i, p: obj.train_fn(i, p),
            FLConfig(transport=TransportConfig(kind="mudp")))

    mgr = CheckpointManager(str(tmp_path / "ckpts"), keep=3)
    journal = FLJournal(str(tmp_path / "journal.log"))

    obj, (sim, system, profiles) = fresh()
    for r in range(3):
        journal.round_started(r, sorted(p.addr for p in profiles))
        result = system.run_round(r)
        path = mgr.save(r, system.global_params,
                        {"loss": obj.loss(system.global_params)})
        journal.round_finalized(r, path, arrived=result.arrived,
                                failed=result.failed)
    want = _digest(system.global_params)

    journal2 = FLJournal(str(tmp_path / "journal.log"))
    assert journal2.resume_round() == 3
    restored, meta = mgr.restore({"w": np.zeros(32, np.float32)})
    assert meta["step"] == 2
    assert _digest(restored) == want

    obj_a, (sim_a, sys_a, _) = fresh()
    sys_a.run_rounds(3)
    r_a = sys_a.run_round(3)
    obj_b, (sim_b, sys_b, _) = fresh()
    sys_b.run_rounds(3)
    sys_b.global_params = restored            # checkpoint swap-in
    r_b = sys_b.run_round(3)
    assert _digest(sys_a.global_params) == _digest(sys_b.global_params)
    assert r_a.arrived == r_b.arrived
