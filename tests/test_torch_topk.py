"""The port's top-k gather/scatter against the reference's Pallas kernels.

The same numpy inputs go through the reference's ``topk_gather_pallas`` /
``topk_scatter_pallas`` (interpret mode, as ``tests/test_kernel_parity.py``
runs them) and through the port's wrappers on CPU tensors (their plain
PyTorch versions).  Both are pure data movement, so the tolerance is
exact: gather and scatter at three shapes, a scatter with duplicate
indices (last wins, like the reference's sequential row loop and numpy
fancy assignment), and the gather -> scatter round trip.  The wrappers
refuse an index outside its row on the CPU as the kernels flag it on the
card.  The CUDA kernels themselves run only on a card (skipped here;
``chip_smoke.py`` holds them against these plain versions).
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.topk.topk import (topk_gather_pallas,  # noqa: E402
                                     topk_scatter_pallas)
from repro_torch import device as port_device  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.topk import ops as topk_ops  # noqa: E402
from repro_torch.kernels.topk import ref as topk_ref  # noqa: E402

SHAPES = [(1, 64, 4), (7, 1000, 50), (16, 4096, 41)]


@pytest.fixture(autouse=True)
def _cpu():
    with port_device.use_device("cpu"):
        yield


def _unique_idx(rng, n_items, p, k):
    return np.sort(np.stack([rng.choice(p, size=k, replace=False)
                             for _ in range(n_items)]), axis=1).astype(
                                 np.int32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("n_items,p,k", SHAPES)
def test_gather_matches_pallas_exactly(n_items, p, k):
    rng = np.random.default_rng(n_items * 131 + p)
    batch = rng.standard_normal((n_items, p)).astype(np.float32)
    idx = _unique_idx(rng, n_items, p, k)
    ours = topk_ops.topk_gather(_t(batch), _t(idx)).numpy()
    theirs = np.asarray(topk_gather_pallas(jnp.asarray(batch),
                                           jnp.asarray(idx)))
    np.testing.assert_array_equal(ours.view(np.uint32),
                                  theirs.view(np.uint32))
    np.testing.assert_array_equal(ours, np.take_along_axis(batch, idx, 1))


@pytest.mark.parametrize("n_items,p,k", SHAPES)
def test_scatter_matches_pallas_exactly(n_items, p, k):
    rng = np.random.default_rng(n_items * 17 + p)
    idx = _unique_idx(rng, n_items, p, k)
    vals = rng.standard_normal((n_items, k)).astype(np.float32)
    ours = topk_ops.topk_scatter(_t(idx), _t(vals), p).numpy()
    theirs = np.asarray(topk_scatter_pallas(jnp.asarray(idx),
                                            jnp.asarray(vals), n=p))
    np.testing.assert_array_equal(ours.view(np.uint32),
                                  theirs.view(np.uint32))


def test_scatter_duplicate_indices_last_wins():
    idx = np.array([[3, 3, 7], [0, 5, 0]], np.int32)
    vals = np.array([[1., 2., 3.], [4., 5., 6.]], np.float32)
    ours = topk_ops.topk_scatter(_t(idx), _t(vals), 8).numpy()
    theirs = np.asarray(topk_scatter_pallas(jnp.asarray(idx),
                                            jnp.asarray(vals), n=8))
    dense = np.zeros((2, 8), np.float32)
    dense[np.repeat(np.arange(2), 3), idx.reshape(-1)] = vals.reshape(-1)
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(ours, dense)
    assert ours[0, 3] == 2.0 and ours[1, 0] == 6.0


def test_scatter_unordered_rows_resolve_like_numpy():
    """Many duplicates in unsorted rows (a malformed payload): the plain
    version's amax-winner rule equals numpy's sequential assignment."""
    rng = np.random.default_rng(3)
    idx = rng.integers(0, 50, (6, 200)).astype(np.int32)
    vals = rng.standard_normal((6, 200)).astype(np.float32)
    dense = np.zeros((6, 50), np.float32)
    dense[np.repeat(np.arange(6), 200), idx.reshape(-1)] = vals.reshape(-1)
    np.testing.assert_array_equal(
        topk_ops.topk_scatter(_t(idx), _t(vals), 50).numpy(), dense)


def test_gather_scatter_roundtrip():
    rng = np.random.default_rng(9)
    batch = rng.standard_normal((5, 300)).astype(np.float32)
    idx = _unique_idx(rng, 5, 300, 30)
    vals = topk_ops.topk_gather(_t(batch), _t(idx))
    dense = topk_ops.topk_scatter(_t(idx), vals, 300).numpy()
    want = np.zeros_like(batch)
    np.put_along_axis(want, idx, np.take_along_axis(batch, idx, 1), 1)
    np.testing.assert_array_equal(dense, want)


def test_plain_versions_on_empty_inputs():
    empty = torch.zeros((3, 0), dtype=torch.int32)
    assert topk_ops.topk_gather(torch.ones(3, 5), empty).shape == (3, 0)
    out = topk_ops.topk_scatter(empty, torch.zeros(3, 0), 5)
    assert out.shape == (3, 5) and not out.any()


def test_wrappers_reject_bad_inputs():
    x = torch.zeros(2, 10)
    with pytest.raises(IndexError, match=r"\[0, 10\)"):
        topk_ops.topk_gather(x, torch.tensor([[1], [10]], dtype=torch.int32))
    with pytest.raises(IndexError, match=r"\[0, 10\)"):
        topk_ops.topk_scatter(torch.tensor([[-1]], dtype=torch.int32),
                              torch.ones(1, 1), 10)
    with pytest.raises(ValueError, match="int32"):
        topk_ops.topk_gather(x, torch.zeros((2, 1), dtype=torch.int64))
    with pytest.raises(ValueError, match="float32"):
        topk_ops.topk_scatter(torch.zeros((1, 1), dtype=torch.int32),
                              torch.ones(1, 1, dtype=torch.float64), 4)
    with pytest.raises(ValueError, match="differ in shape"):
        topk_ops.topk_scatter(torch.zeros((1, 2), dtype=torch.int32),
                              torch.ones(1, 1), 4)


def test_cpu_tensors_never_launch():
    kernels.reset_launch_counts()
    rng = np.random.default_rng(1)
    idx = _t(_unique_idx(rng, 2, 40, 5))
    vals = topk_ops.topk_gather(torch.ones(2, 40), idx)
    topk_ops.topk_scatter(idx, vals, 40)
    assert kernels.launch_counts["topk_gather"] == 0
    assert kernels.launch_counts["topk_scatter"] == 0


def test_cuda_kernels_match_plain_versions_bitwise():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check "
                    "on the card")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    for n_items, p, k in SHAPES:
        x = _t(rng.standard_normal((n_items, p)).astype(np.float32)).to(dev)
        idx = _t(_unique_idx(rng, n_items, p, k)).to(dev)
        out = topk_ops.topk_gather(x, idx)
        assert torch.equal(out, topk_ref.gather(x, idx))
        assert torch.equal(topk_ops.topk_scatter(idx, out, p),
                           topk_ref.scatter(idx, out, p))
