"""The port's top-k gather/scatter against the reference's Pallas kernels.

The same numpy inputs go through the reference's ``topk_gather_pallas`` /
``topk_scatter_pallas`` (interpret mode, as ``tests/test_kernel_parity.py``
runs them) and through the port's wrappers on CPU tensors (their plain
PyTorch versions).  Both are pure data movement, so the tolerance is
exact: gather and scatter at three shapes, a scatter with duplicate
indices (last wins, like the reference's sequential row loop and numpy
fancy assignment), and the gather -> scatter round trip.  The wrappers
refuse an index outside its row on the CPU as the kernels flag it on the
card.  The scatter's tile plan (host-side) is checked here, and so is the
gather's stamped flag (``ops.StampedFlags``: a bad call raises, a stale
stamp does not, another stream's or thread's flag is its own).  The CUDA
kernels themselves run only on a card (the ``on_the_card`` cases skip
here; ``chip_smoke.py`` holds them against these plain versions).
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


def test_gather_stamped_flags_raise_exactly_at_the_bad_calls():
    """The gather's flag is never zeroed: each call gets a fresh stamp and
    the kernel stores it on a bad index (stood in for here by a fill on
    a CPU flag).  good, bad, good, bad, bad raise at the bad calls only;
    a bad call on another key (stream or thread) neither raises here nor
    hides this key's error."""
    flags = topk_ops.StampedFlags()
    mine, other = flags.flag(("dev", 1, 7), "cpu"), flags.flag(("dev", 2, 7),
                                                              "cpu")
    assert flags.flag(("dev", 1, 7), "cpu") is mine and other is not mine
    assert mine.dtype == torch.int64 and int(mine.item()) == 0

    def call(flag, bad):
        stamp = flags.stamp()
        if bad:
            flag.fill_(stamp)                  # the kernel's store
        return flags.raised(flag, stamp)
    assert [call(mine, bad) for bad in (False, True, False, True, True)] \
        == [False, True, False, True, True]
    # a bad call on the other key between this key's launch and read
    stamp = flags.stamp()
    mine.fill_(stamp)
    assert call(other, True)
    assert flags.raised(mine, stamp)
    assert not call(mine, False)


def test_gather_stamps_are_unique_across_threads():
    import threading
    flags = topk_ops.StampedFlags()
    got: list[int] = []

    def take():
        got.extend(flags.stamp() for _ in range(500))
    threads = [threading.Thread(target=take) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sorted(got) == list(range(1, 2001))


def test_gather_bad_index_sequence_on_the_card():
    """On the card: good, bad, good, bad, bad on one stream raise at the
    bad calls only, each good call equal to the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these checks "
                    "on the card")
    rng = np.random.default_rng(24)
    dev = torch.device("cuda")
    x = _t(rng.standard_normal((4, 25_450)).astype(np.float32)).to(dev)
    good = _unique_idx(rng, 4, 25_450, 1018)
    bad = good.copy()
    bad[2, 500] = 25_450
    idx = {False: _t(good).to(dev), True: _t(bad).to(dev)}
    for is_bad in (False, True, False, True, True):
        if is_bad:
            with pytest.raises(IndexError, match=r"\[0, 25450\)"):
                topk_ops.topk_gather(x, idx[True])
        else:
            assert torch.equal(topk_ops.topk_gather(x, idx[False]),
                               topk_ref.gather(x, idx[False]))


# The scatter's tile plan: (rows, n) -> columns a CTA, at the wire plane's
# shapes (one client's row; the server's tier groups), a large one, rows
# past a grid's 65,535, and rows narrower than one tile.
TILE_PLANS = [((1, 25_450), 1024), ((18, 25_450), 4096), ((25, 25_450), 5120),
              ((64, 1 << 20), 16_384), ((70_000, 13), 16), ((2, 1), 4),
              ((8, 30_000), 2048)]


@pytest.mark.parametrize("shape,tile", TILE_PLANS)
def test_scatter_tile_plan(shape, tile):
    rows, n = shape
    got = topk_ops.scatter_tile(rows, n)
    assert got == tile
    assert got % 4 == 0 and 4 <= got <= topk_ops.SCATTER_MAX_TILE
    assert got >= min(topk_ops.SCATTER_MIN_TILE, n)
    scratch = topk_ops.scatter_scratch(rows, "cpu")
    assert scratch.dtype == torch.int32 and scratch.numel() == 2 + 2 * rows


def _dense(idx, vals, n):
    rows, k = idx.shape
    out = np.zeros((rows, n), np.float32)
    out[np.repeat(np.arange(rows), k), idx.reshape(-1)] = vals.reshape(-1)
    return out


def _scatter_edge(name, rng):
    """(idx, vals, n) of one of the scatter kernel's edge cases."""
    def inc(k, lo, hi):
        return np.sort(rng.choice(np.arange(lo, hi), k, replace=False))
    if name == "mixed":           # 15 tiles; unordered rows, duplicates
        n = 30_000
        t = topk_ops.scatter_tile(6, n)
        rep = inc(5000, 0, n)
        rep[2500] = rep[2499]
        idx = np.stack([inc(5000, 0, n), rng.integers(0, n, 5000), rep,
                        inc(5000, 0, n)[::-1], rng.integers(t, 4 * t, 5000),
                        rng.integers(2 * t, 3 * t, 5000)])
    elif name == "short_mixed":   # K <= 1024: each CTA sees the whole row
        n = 25_450
        idx = np.stack([inc(1018, 0, n), rng.integers(0, n, 1018),
                        rng.integers(0, 900, 1018)])
    elif name == "one_tile":
        n = 25_450
        t = topk_ops.scatter_tile(3, n)
        idx = np.stack([inc(800, 0, t), inc(800, 5 * t, 6 * t),
                        inc(800, (n - 1) // t * t, n)])
    elif name == "k0":
        n, idx = 25_450, np.zeros((4, 0), np.int64)
    elif name == "ragged":        # n % 4 = 3, rows off the 16-byte grid
        n = 25_451
        idx = np.stack([inc(3817, 0, n) for _ in range(5)])
    elif name == "tiny":
        n, idx = 3, np.stack([inc(2, 0, 3) for _ in range(3)])
    elif name == "many_rows":     # past a grid's 65,535 rows
        n = 13
        idx = np.stack([inc(3, 0, n) for _ in range(70_000)])
        idx[-1] = [5, 2, 5]
    else:                         # large: two search rounds, a ticket a row
        n = 1 << 20
        idx = np.stack([inc(157_286, 0, n) for _ in range(2)])
        idx[1, 1000:1010] = idx[1, 1000]
    idx = idx.astype(np.int32)
    return idx, rng.standard_normal(idx.shape).astype(np.float32), n


@pytest.mark.parametrize("case", ["mixed", "short_mixed", "one_tile", "k0",
                                  "ragged", "tiny", "many_rows", "large"])
def test_scatter_edges_on_the_card(case):
    """The scatter kernel at its edge cases, bitwise against the plain
    version and numpy's sequential assignment (last write wins)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these checks "
                    "on the card")
    idx, vals, n = _scatter_edge(case, np.random.default_rng(21))
    dev = torch.device("cuda")
    got = topk_ops.topk_scatter(_t(idx).to(dev), _t(vals).to(dev), n).cpu()
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  _dense(idx, vals, n).view(np.uint32))
    assert torch.equal(got, topk_ref.scatter(_t(idx), _t(vals), n))


@pytest.mark.parametrize("bad,k", [(25_450, 1018), (-1, 3817),
                                   (1 << 30, 10_180)])
def test_scatter_bad_index_raises_on_the_card(bad, k):
    """A bad index in a row short enough for each CTA to see it whole
    (1018), and in longer rows (resolved by the row's last CTA)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these checks "
                    "on the card")
    rng = np.random.default_rng(22)
    idx = np.stack([np.sort(rng.choice(25_450, k, replace=False))
                    for _ in range(4)]).astype(np.int32)
    idx[2, 500] = bad
    dev = torch.device("cuda")
    with pytest.raises(IndexError, match=r"\[0, 25450\)"):
        topk_ops.topk_scatter(_t(idx).to(dev),
                              torch.ones(idx.shape, device=dev), 25_450)
