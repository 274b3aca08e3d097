"""The port's pod-axis FL aggregation (``repro_torch.distributed.fl_mesh``)
against the reference's ``make_fl_aggregate``.

The reference runs as its own tests run it (``tests/test_perf_features.py``):
in a subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count``
and a ``("pod",)`` mesh of P host devices.  Both packages get the same
tree (float32 and bfloat16 leaves of rank 1-3 a pod, drawn from a seed
with numpy).  Tolerances:

* P = 2, ``exact``: bitwise (fedavg's ``0.5 * x0 + 0.5 * x1`` is the
  reference's ``(x0 + x1) / 2`` exactly);
* P = 2, ``int8``: each package bitwise against its own arithmetic on the
  same codes and scales.  The port sums the rounded products
  ``fl(q0 * s0) + fl(q1 * s1)``, as the reference's source reads; XLA's
  CPU backend contracts the second product into the sum
  (``fma(q1, s1, fl(q0 * s0))``), which moves 8 of 37 float32 means of
  the first leaf by one ulp.  So the two packages agree within one ulp
  (of the leaf's dtype) of the row's absmax over the pods;
* P = 3: within 4 ulp (of the leaf's dtype) of the row's absmax over the
  pods, since fedavg folds ``sum_k fl(x_k / 3)`` where the reference
  sums and then divides;
* the 1024-block leaf codec (``_quantize_leaf`` / ``_dequantize_leaf``):
  bitwise.

On the CPU each kernel wrapper runs its plain version; the card's run is
``chip_smoke.py``'s phase 14.
"""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.distributed import fl_mesh as ref_fl  # noqa: E402
from repro_torch import spans  # noqa: E402
from repro_torch.distributed import fl_mesh  # noqa: E402
from repro_torch.kernels.fedavg import ops as fedavg_ops  # noqa: E402
from repro_torch.kernels.quantize import ops as quant_ops  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: leaf -> (per-pod shape, dtype)
LEAVES = {"bias": ((37,), "float32"), "norm": ((1600,), "bfloat16"),
          "w": ((5, 64), "bfloat16"), "proj": ((3, 4, 300), "float32"),
          "emb": ((11, 1025), "float32")}
ULPS = 4
#: each leaf's phase spans, in order: the fold writes every pod's copy in
#: the leaf's dtype, so no cast back or broadcast follows it
PHASES = {"exact": ("fold",), "int8": ("cast", "codec", "fold")}
#: aten ops a call makes outside every phase that do no device work: the
#: fold's result viewed back to the leaf's shape
NO_WORK = {"aten::view"}

_REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ['XLA_FLAGS'] = (
        '--xla_force_host_platform_device_count=' + sys.argv[1])
    import jax, jax.numpy as jnp, numpy as np
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
    np.savez(sys.argv[3], **out)
    print('OK')
""")


def make_tree(pods: int, seed: int = 0) -> dict:
    """Per leaf the (P, ...) float32 draws: a shared model plus a pod's
    own update, rows of unequal scale."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, (shape, _) in LEAVES.items():
        base = rng.standard_normal(shape).astype(np.float32)
        scale = np.exp(rng.uniform(-3, 3, shape[:-1] + (1,)))
        out[name] = np.stack([
            (base + 0.1 * rng.standard_normal(shape)) * scale
            for _ in range(pods)]).astype(np.float32)
    return out


def reference(tmp_path, pods: int, tree: dict) -> dict:
    src, dst = tmp_path / "tree.npz", tmp_path / "ref.npz"
    np.savez(src, **tree, **{"dtype_" + k: np.array(LEAVES[k][1])
                             for k in tree})
    r = subprocess.run([sys.executable, "-c", _REFERENCE, str(pods),
                        str(src), str(dst)], capture_output=True, text=True,
                       timeout=600, cwd=ROOT,
                       env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin",
                            "JAX_PLATFORMS": "cpu"})
    assert "OK" in r.stdout, r.stderr[-2000:]
    with np.load(dst) as f:
        return dict(f)


def port(tree: dict) -> dict:
    stacked = {k: torch.from_numpy(v).to(getattr(torch, LEAVES[k][1]))
               for k, v in tree.items()}
    out = {}
    for mode in fl_mesh.MODES:
        agg = fl_mesh.make_fl_aggregate(fl_mesh.client_mesh(), mode=mode)
        for k, v in agg(stacked).items():
            assert v.dtype == stacked[k].dtype and v.shape == stacked[k].shape
            out[f"{mode}/{k}"] = v.float().numpy()
    return out


def pod_sums(x: np.ndarray, dtype: str) -> tuple[np.ndarray, np.ndarray]:
    """Two pods' int8 means from the row-wise codes and scales, cast to
    ``dtype`` and back: ``(fl(q0 s0) + fl(q1 s1)) / 2`` and, as XLA's CPU
    backend contracts it, ``fma(q1, s1, fl(q0 s0)) / 2`` (the product of
    an int8 code and a float32 scale and its sum are exact in float64)."""
    rows = torch.from_numpy(x).to(getattr(torch, dtype)).float()
    d = rows.shape[-1]
    q, s = quant_ops.quantize(rows.reshape(-1, d).contiguous(), d)
    q = q.numpy().reshape(2, -1, d).astype(np.float64)
    s = s.numpy().reshape(2, -1, 1).astype(np.float64)
    deq0 = (q[0] * s[0]).astype(np.float32)
    deq1 = (q[1] * s[1]).astype(np.float32)
    fma = (q[1] * s[1] + deq0).astype(np.float32)
    half = np.float32(2)

    def cast(m):
        t = torch.from_numpy((m / half).reshape(x.shape[1:]))
        return t.to(getattr(torch, dtype)).float().numpy()
    return cast(deq0 + deq1), cast(fma)


def _ulp(x: np.ndarray, dtype: str) -> np.ndarray:
    mant = 23 if dtype == "float32" else 7
    return np.exp2(np.floor(np.log2(np.maximum(x, 1e-30))) - mant)


@pytest.mark.parametrize("pods", [2, 3])
def test_pod_aggregation_matches_the_reference(tmp_path, pods):
    tree = make_tree(pods, seed=pods)
    want = reference(tmp_path, pods, tree)
    got = port(tree)
    assert set(got) == set(want)
    for key in sorted(want):
        g, w = got[key], want[key]
        name = key.split("/")[1]
        # every pod holds the aggregate
        assert (g == g[:1]).all() and (w == w[:1]).all(), key
        if pods == 2 and key.startswith("exact"):
            assert np.array_equal(g.view(np.int32), w.view(np.int32)), key
            continue
        if pods == 2:
            unfused, fused = pod_sums(tree[name], LEAVES[name][1])
            assert np.array_equal(g[0].view(np.int32),
                                  unfused.view(np.int32)), key
            assert np.array_equal(w[0].view(np.int32),
                                  fused.view(np.int32)), key
        absmax = np.abs(tree[name].astype(np.float32)).max(axis=(0, -1),
                                                          keepdims=True)
        ulps = 1 if pods == 2 else ULPS
        tol = ulps * _ulp(absmax[0], LEAVES[name][1])
        assert (np.abs(g - w) <= tol).all(), (key, np.abs(g - w).max())


def test_int8_sits_within_the_codec_bound_of_exact():
    """Per row, |int8 - exact| <= absmax / 254 (the largest over the
    pods), on the float32 means before the cast back."""
    tree = make_tree(4, seed=7)
    for name, x in tree.items():
        t = torch.from_numpy(x)
        exact = fl_mesh.pod_mean(t, "exact").numpy()
        int8 = fl_mesh.pod_mean(t, "int8").numpy()
        bound = np.abs(x).max(axis=(0, -1)) / 254
        assert (np.abs(int8 - exact).max(axis=-1) <= bound).all(), name


def test_leaf_codec_is_bitwise():
    rng = np.random.default_rng(3)
    for shape in [(2500,), (7, 300), (4, 1024)]:
        pods = [rng.standard_normal(shape).astype(np.float32) * 10
                for _ in range(2)]
        codes, scales = [], []
        for x in pods:
            q_r, s_r = ref_fl._quantize_leaf(jnp.asarray(x))
            q_p, s_p = fl_mesh._quantize_leaf(torch.from_numpy(x))
            np.testing.assert_array_equal(q_p.numpy(), np.asarray(q_r))
            assert np.array_equal(s_p.numpy().view(np.int32),
                                  np.asarray(s_r).view(np.int32))
            codes.append(q_p)
            scales.append(s_p)
        for dt, jdt in ((torch.float32, jnp.float32),
                        (torch.bfloat16, jnp.bfloat16)):
            got = fl_mesh._dequantize_leaf(torch.stack(codes),
                                           torch.stack(scales), shape, dt)
            want = ref_fl._dequantize_leaf(
                jnp.asarray(torch.stack(codes).numpy()),
                jnp.asarray(torch.stack(scales).numpy()), shape, jdt)
            assert np.array_equal(
                got.float().numpy().view(np.int32),
                np.asarray(want.astype(jnp.float32)).view(np.int32))


def test_a_0d_leaf_has_no_row_to_quantize():
    stacked = {"scalar": torch.ones(2), "w": torch.ones(2, 3)}
    agg = fl_mesh.make_fl_aggregate(fl_mesh.client_mesh(), mode="int8")
    with pytest.raises(ValueError, match="0-d"):
        agg(stacked)
    exact = fl_mesh.make_fl_aggregate(fl_mesh.client_mesh(), mode="exact")
    assert exact(stacked)["scalar"].tolist() == [1.0, 1.0]
    with pytest.raises(ValueError):
        fl_mesh.make_fl_aggregate(fl_mesh.client_mesh(), mode="topk")
    # the reference raises on the same leaf (one pod on one host device)
    mesh = jax.make_mesh((1,), ("pod",))
    with pytest.raises(Exception):
        ref_fl.make_fl_aggregate(mesh, mode="int8")(
            {"scalar": jnp.ones((1,))})


def test_each_leaf_goes_through_the_three_wrappers(monkeypatch):
    calls = {"fedavg": 0, "quantize": 0, "dequantize": 0}

    def spy(mod, name):
        fn = getattr(mod, name)

        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)
    spy(fedavg_ops, "fedavg")
    spy(quant_ops, "quantize")
    spy(quant_ops, "dequantize")
    tree = {k: torch.from_numpy(v) for k, v in make_tree(2).items()}
    fl_mesh.make_fl_aggregate(fl_mesh.client_mesh(), mode="int8")(tree)
    assert calls == {"fedavg": 5, "quantize": 5, "dequantize": 5}
    fl_mesh.make_fl_aggregate(fl_mesh.client_mesh(), mode="exact")(tree)
    assert calls == {"fedavg": 10, "quantize": 5, "dequantize": 5}


@pytest.mark.parametrize("mode", fl_mesh.MODES)
def test_each_pods_copy_of_the_aggregate_is_its_own_storage(mode):
    tree = _stacked(3)
    out = fl_mesh.make_fl_aggregate(fl_mesh.client_mesh(), mode=mode)(tree)
    for name, leaf in out.items():
        assert leaf.shape == tree[name].shape and leaf.is_contiguous()
        before = leaf.clone()
        leaf[1].fill_(7.0)                # one pod trains on its copy
        assert torch.equal(leaf[0], before[0]), name
        assert torch.equal(leaf[2], before[2]), name
        assert torch.equal(tree[name], _stacked(3)[name]), name


def test_stacking_helpers():
    x = {"a": torch.arange(6.).view(2, 3), "b": torch.ones(4)}
    st = fl_mesh.stack_for_pods(x, 3)
    assert st["a"].shape == (3, 2, 3) and st["b"].shape == (3, 4)
    st["a"][0, 0, 0] = 9.0            # each pod's copy is its own
    assert st["a"][1, 0, 0] == 0.0 and x["a"][0, 0] == 0.0
    assert fl_mesh.stacked_specs({"w": ("w_data", None), "n": (None,)}) == \
        ref_fl.stacked_specs({"w": ("w_data", None), "n": (None,)})


def _stacked(pods: int = 2) -> dict:
    return {k: torch.from_numpy(v).to(getattr(torch, LEAVES[k][1]))
            for k, v in make_tree(pods).items()}


def _profiled(agg, tree):
    """``agg(tree)`` under a CPU profile: (the aggregate, every host event
    as (name, start ns, end ns), by start)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = agg(tree)
    events = sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                     for e in prof.profiler.kineto_results.events()),
                    key=lambda e: e[1])
    return out, events


@pytest.mark.parametrize("mode", fl_mesh.MODES)
def test_spans_cover_every_phase_of_every_leaf(mode):
    tree = _stacked()
    _, events = _profiled(
        fl_mesh.make_fl_aggregate(fl_mesh.client_mesh(), mode=mode), tree)
    ranges = [e for e in events if e[0].startswith(spans.PREFIX)]
    aggs = [e for e in ranges if e[0] == spans.PREFIX + "fl_mesh.aggregate"]
    assert len(aggs) == 1
    _, a0, a1 = aggs[0]
    phases = [e for e in ranges if e not in aggs]
    # each leaf: one range of each of its mode's phases, in order
    assert [n for n, _, _ in phases] == [
        spans.PREFIX + "fl_mesh." + p for p in PHASES[mode]] * len(tree)
    assert all(a0 <= s and e <= a1 for _, s, e in phases)
    # every op inside the call that would work on a card lies in a phase
    work = [e for e in events if e[0].startswith("aten::")
            and a0 <= e[1] <= a1 and e[0] not in NO_WORK]
    assert {n for n, _, _ in work} >= {"aten::copy_", "aten::fill_"}
    outside = [n for n, s, e in work
               if not any(ps <= s and e <= pe for _, ps, pe in phases)]
    assert outside == []


@pytest.mark.parametrize("mode", fl_mesh.MODES)
def test_spans_are_a_shared_no_op_without_a_profiler(monkeypatch, mode):
    tree = _stacked()
    agg = fl_mesh.make_fl_aggregate(fl_mesh.client_mesh(), mode=mode)
    traced, _ = _profiled(agg, tree)

    def refuse(*args, **kwargs):
        raise AssertionError("a range was made with no profiler running")
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    assert spans.span("fl_mesh.cast") is spans.span("fl_mesh.aggregate")
    plain = agg(tree)
    for k in tree:
        assert torch.equal(plain[k].view(torch.uint8),
                           traced[k].view(torch.uint8)), k
