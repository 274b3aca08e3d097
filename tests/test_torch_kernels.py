"""The port's kernels (plain PyTorch versions on the CPU) against the
reference's host numpy path and its Pallas kernels (interpret mode).

* fedavg: bitwise equal to ``repro.core.aggregation.fedavg_stack(...,
  "numpy")`` (the same float32 fold, no FMA), also at the flow fleets'
  tall, narrow stacks and at strides off the 16-byte grid; within
  ``rtol=atol=1e-6`` of the Pallas kernel, which reduces over clients in
  a tree.  The CUDA kernel's dispatch plan covers every column once and
  fills the SMs.
* quantize: bitwise equal to ``quantize_int8_batch`` at any block (also
  at the CUDA kernel's edge shapes); against the Pallas kernel (block
  1024) and its jnp oracle (other blocks) scales agree to 1 ULP and codes
  to one step.  The kernel's plan (``ops.quantize_plan``) takes every
  block once, with the fewest lanes and units of its route, and picks the
  expected route at the paths' shapes.
* dequantize: bitwise equal to both.
* the ``"kernel"`` backends dispatch to the plain versions on CPU tensors
  (no library is built or loaded), and asking for ``cuda`` without a card
  raises.
"""

from __future__ import annotations

import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import aggregation as ref_agg  # noqa: E402
from repro.core.compression import (dequantize_int8_batch,  # noqa: E402
                                    quantize_int8_batch)
from repro.kernels.fedavg import ops as pallas_fedavg  # noqa: E402
from repro.kernels.quantize import ops as pallas_quant  # noqa: E402
from repro.kernels.quantize import ref as jnp_quant  # noqa: E402
from repro_torch import device as port_device  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.core import aggregation as port_agg  # noqa: E402
from repro_torch.core import wire as port_wire  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.fedavg import ops as fedavg_ops  # noqa: E402
from repro_torch.kernels.fedavg import ref as fedavg_ref  # noqa: E402
from repro_torch.kernels.quantize import ops as quant_ops  # noqa: E402
from repro_torch.kernels.quantize import ref as quant_ref  # noqa: E402


def _bits(a) -> np.ndarray:
    """float32 array viewed as its raw bits (bitwise comparison that also
    tells -0.0 from 0.0)."""
    return np.ascontiguousarray(np.asarray(a, dtype=np.float32)).view(
        np.uint32)


def _stack(k: int, n: int) -> tuple[np.ndarray, list[float]]:
    rng = np.random.default_rng(1000 * k + n)
    stack = rng.standard_normal((k, n)).astype(np.float32)
    weights = (rng.random(k) * 2.0 + 0.1).tolist()
    return stack, weights


@pytest.fixture(autouse=True)
def _cpu():
    with port_device.use_device("cpu"):
        yield


# --------------------------------------------------------------------------
# fedavg
# --------------------------------------------------------------------------
# The grid of short stacks, then the tall, narrow and unaligned ones the
# kernel's routes serve: the flow fleets' cells (188 and 1875 clients of
# 2048 parameters), the MLP's hier cells (12 x 25450, a row stride off
# the 16-byte grid) and a tall stack whose stride is off it too.
FEDAVG_SHAPES = ([(k, n) for k in (1, 2, 5, 16) for n in (1, 1000, 16385,
                                                           25450)]
                 + [(188, 2048), (1875, 2048), (12, 25450), (190, 2050)])


@pytest.mark.parametrize("k,n", FEDAVG_SHAPES)
def test_fedavg_plain_matches_numpy_bitwise_and_pallas(k, n):
    stack, weights = _stack(k, n)
    ours = port_agg.fedavg_stack(stack, weights, "kernel")
    host = ref_agg.fedavg_stack(stack, weights, backend="numpy")
    np.testing.assert_array_equal(_bits(ours), _bits(host))
    np.testing.assert_array_equal(
        _bits(port_agg.fedavg_stack(stack, weights, "numpy")), _bits(host))
    pallas = np.asarray(pallas_fedavg.fedavg_flat(stack, weights))
    np.testing.assert_allclose(ours, pallas, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("n", [1, 7, 2048, 2050, 25450, 1 << 24])
def test_fedavg_plan_covers_each_column_once_and_fills_the_card(n, aligned):
    """The kernel's dispatch: CTA b folds the columns [b * tile, (b + 1) *
    tile) below n, so the grid covers each column exactly once; it fills
    the H100's 132 SMs wherever N / 8 >= 132; TMA only where the row
    stride is on the 16-byte grid; short stacks and wide ones take the
    wide route, the rest a tall one with 4 KB stages up to 512 clients."""
    ops = fedavg_ops
    for k in (0, 1, 32, 33, 188, 512, 513, 1875, 60_000):
        p = ops.plan(k, n, aligned)
        starts = np.arange(p.blocks(n), dtype=np.int64) * p.tile
        ends = np.minimum(starts + p.tile, n)
        assert starts[0] == 0 and ends[-1] == n
        np.testing.assert_array_equal(starts[1:], ends[:-1])
        assert (ends > starts).all()
        if n / 8 >= ops.SMS:
            assert p.blocks(n) >= ops.SMS
        wide = k <= ops.SHORT_K or n >= 2 * ops.SMS * ops.WIDE_TILES[0]
        assert (p.route == "wide") == wide
        if wide:
            assert p.tile in ops.WIDE_TILES and p.stage == 0
        else:
            assert p.route == ("tma" if aligned else "cp_async")
            assert p.tile in ops.TALL_TILES
            assert p.stage == (1024 if k <= ops.SHORT_STAGE_K and p.tile <= 64
                               else 2048)
            assert 16 <= p.stage // p.tile <= 256      # rows a stage
    assert ops.plan(1875, 2048, True) == ("tma", 8, 2048)
    assert ops.plan(188, 2048, True) == ("tma", 8, 1024)
    assert ops.plan(188, 2048, False) == ("cp_async", 8, 1024)
    assert ops.plan(32, 2048, True) == ("wide", 8, 0)
    assert ops.plan(12, 25450, False) == ("wide", 128, 0)
    assert ops.plan(600, 25450, False) == ("cp_async", 128, 2048)
    assert ops.plan(16, 1 << 24, True) == ("wide", 256, 0)
    assert ops.plan(3, 140_570_352, True) == ("wide", 256, 0)


def test_fedavg_alignment_is_the_bases_and_row_stride_on_the_16_byte_grid():
    w = torch.ones(8)
    assert fedavg_ops.is_aligned(torch.zeros((3, 2048)), w[:3])
    assert not fedavg_ops.is_aligned(torch.zeros((3, 2050)), w[:3])
    assert not fedavg_ops.is_aligned(torch.zeros((3, 2048)), w[1:4])
    buf = torch.zeros(3 * 2048 + 4)
    assert buf.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    assert not fedavg_ops.is_aligned(buf[1:1 + 3 * 2048].view(3, 2048),
                                     w[:3])
    assert fedavg_ops.is_aligned(buf[4:].view(3, 2048), w[4:7])


def test_fedavg_ref_is_the_fold_over_normalized_weights():
    stack, weights = _stack(3, 257)
    w = np.asarray(weights, np.float32)
    w = w / w.sum()
    out = fedavg_ref.fedavg(torch.from_numpy(stack), torch.from_numpy(w))
    acc = np.zeros(257, np.float32)
    for wi, row in zip(w, stack):
        acc += wi * row
    np.testing.assert_array_equal(_bits(out.numpy()), _bits(acc))


def test_fedavg_rejects_bad_inputs():
    with pytest.raises(ValueError, match="2-D float32"):
        fedavg_ops.fedavg(torch.zeros(4), torch.ones(1))
    with pytest.raises(ValueError, match="weights"):
        fedavg_ops.fedavg(torch.zeros(2, 4), torch.ones(3))
    with pytest.raises(ValueError, match="unknown fedavg backend"):
        port_agg.fedavg_stack(np.zeros((2, 4), np.float32), None, "auto")


# The pod route (``cast_to``): every row's copy of the fold, rounded once
# to the leaf's dtype, as fl_mesh's plain-tree leaves take it.
POD_DTYPES = [torch.bfloat16, torch.float16, torch.float32]


def _pod_stack(k: int, n: int, dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """A (k, n) stack in ``dtype`` and normalized float32 weights."""
    stack, weights = _stack(k, n)
    w = np.asarray(weights, np.float32)
    return (torch.from_numpy(stack * 4).to(dtype),
            torch.from_numpy(w / w.sum()))


def _pod_chain(stack, w, cast_to):
    """The chain the pod route replaces: the cast to float32, the default
    fold, the cast back and the broadcast copy."""
    mean = fedavg_ops.fedavg(stack.to(torch.float32).contiguous(), w)
    return mean.to(cast_to).unsqueeze(0).expand(stack.shape).contiguous()


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    view = {2: torch.int16, 4: torch.int32}
    return (a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(view[a.element_size()]), b.view(view[b.element_size()])))


@pytest.mark.parametrize("n", [1001, 1024])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 33])
@pytest.mark.parametrize("dtype", POD_DTYPES, ids=str)
def test_fedavg_pod_route_is_the_cast_fold_cast_back_broadcast_chain(
        dtype, k, n):
    """On the CPU the wrapper's plain version is bitwise the chain, and
    the chain's mean is the numpy fold of the widened values."""
    stack, w = _pod_stack(k, n, dtype)
    got = fedavg_ops.fedavg(stack, w, cast_to=dtype)
    assert _same_bits(got, _pod_chain(stack, w, dtype))
    assert _same_bits(fedavg_ref.fedavg(stack, w, cast_to=dtype), got)
    acc = np.zeros(n, np.float32)
    for wi, row in zip(w.numpy(), stack.to(torch.float32).numpy()):
        acc += wi * row
    assert _same_bits(got[k - 1].clone(), torch.from_numpy(acc).to(dtype))
    # a float32 stack rounds to each narrower dtype as the int8 fold does
    if dtype != torch.float32:
        f32 = stack.to(torch.float32)
        assert _same_bits(fedavg_ops.fedavg(f32, w, cast_to=dtype),
                          _pod_chain(f32, w, dtype))


@pytest.mark.parametrize("k,n", [(1, 7), (4, 1600), (2, 25450), (33, 2048)])
def test_fedavg_default_call_is_unchanged_beside_the_pod_route(k, n):
    """Without ``cast_to`` the call still takes a float32 stack to its
    float32 (N,) mean, bitwise the host fold, by the routes of ``plan``."""
    stack, weights = _stack(k, n)
    w = np.asarray(weights, np.float32)
    w = torch.from_numpy(w / w.sum())
    x = torch.from_numpy(stack)
    out = fedavg_ops.fedavg(x, w)
    assert out.shape == (n,) and out.dtype == torch.float32
    assert _same_bits(out, fedavg_ops.fedavg(x, w, cast_to=None))
    acc = np.zeros(n, np.float32)
    for wi, row in zip(w.numpy(), stack):
        acc += wi * row
    np.testing.assert_array_equal(_bits(out.numpy()), _bits(acc))


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("n", [1, 7, 8, 16, 1001, 1024, 5504, (1 << 30) + 3,
                               (1 << 30) + 8])
def test_fedavg_pod_plan_covers_each_column_once_on_the_grid(n, itemsize):
    """Vectors of 16 bytes from the first column on the grid, in every row,
    where rows share an alignment (n a multiple of the vector); every
    other column alone; each column exactly once."""
    v = 16 // itemsize
    for base in range(0, 16, itemsize):
        p = fedavg_ops.pod_plan(4, n, itemsize, 4096 + base)
        assert p.rows == 4
        head = -base % 16 // itemsize
        if n % v or n - head < v:
            assert (p.head, p.vecs) == (0, 0)
        else:
            assert (p.head, p.vecs) == (head, (n - head) // v)
            assert (base + p.head * itemsize) % 16 == 0
        if n > 1 << 20:
            continue
        # the kernel's columns: vectors from the head on, then the head's
        # and the tail's columns one each
        seen = np.zeros(n, np.int64)
        end = p.head + p.vecs * v
        seen[p.head:end] += 1
        seen[:p.head] += 1
        seen[end:] += 1
        assert (seen == 1).all() and end <= n
    rows = [fedavg_ops.pod_plan(k, 64, 2, 0).rows
            for k in (1, 2, 3, 4, 5, 8, 9, 32, 33, 60_000)]
    assert rows == [2, 2, 4, 4, 8, 8, 32, 32, 32, 32]


def test_fedavg_pod_route_rejects_what_it_cannot_cast():
    w = torch.full((2,), 0.5)
    with pytest.raises(ValueError, match="casts to"):
        fedavg_ops.fedavg(torch.zeros(2, 4), w, cast_to=torch.int8)
    with pytest.raises(ValueError, match="bfloat16 or float16"):
        fedavg_ops.fedavg(torch.zeros(2, 4, dtype=torch.float64), w,
                          cast_to=torch.float32)
    with pytest.raises(ValueError, match="2-D float32"):
        fedavg_ops.fedavg(torch.zeros(2, 4, dtype=torch.bfloat16), w)
    with pytest.raises(ValueError, match="weights"):
        fedavg_ops.fedavg(torch.zeros(2, 4), w[:1], cast_to=torch.float32)


# --------------------------------------------------------------------------
# quantize / dequantize
# --------------------------------------------------------------------------
QUANT_SHAPES = [(1, 1), (3, 1000), (4, 2049), (16, 25450)]


def _mat(rows: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(7 * rows + n)
    mat = rng.standard_normal((rows, n)).astype(np.float32)
    mat[:, ::97] *= 40.0        # uneven block ranges
    return mat


def _ulp_diff(a: np.ndarray, b: np.ndarray) -> int:
    ia = _bits(a).astype(np.int64)
    ib = _bits(b).astype(np.int64)
    return int(np.abs(ia - ib).max()) if ia.size else 0


@pytest.mark.parametrize("block", [1024, 512])
@pytest.mark.parametrize("rows,n", QUANT_SHAPES)
def test_quantize_plain_matches_numpy_bitwise_and_pallas(rows, n, block):
    mat = _mat(rows, n)
    q, s = quant_ops.quantize(torch.from_numpy(mat), block)
    q_np, s_np = quantize_int8_batch(mat, block)
    np.testing.assert_array_equal(q.numpy(), q_np)
    np.testing.assert_array_equal(_bits(s.numpy()), _bits(s_np))
    if block == pallas_quant.QBLOCK:
        q_j, s_j = pallas_quant.quantize_matrix(mat)
    else:
        nb = -(-n // block)
        padded = np.zeros((rows, nb * block), np.float32)
        padded[:, :n] = mat
        q_j, s_j = jnp_quant.quantize_blockwise(
            jnp.asarray(padded.reshape(rows * nb, block)))
    q_j = np.asarray(q_j).reshape(q_np.shape)
    s_j = np.asarray(s_j).reshape(s_np.shape)
    assert _ulp_diff(s.numpy(), s_j) <= 1
    assert int(np.abs(q.numpy().astype(np.int32)
                      - q_j.astype(np.int32)).max()) <= 1


@pytest.mark.parametrize("block", [1024, 512])
@pytest.mark.parametrize("rows,n", QUANT_SHAPES)
def test_dequantize_plain_matches_numpy_and_pallas_bitwise(rows, n, block):
    q_np, s_np = quantize_int8_batch(_mat(rows, n), block)
    out = quant_ops.dequantize(torch.from_numpy(q_np),
                               torch.from_numpy(s_np), n, block)
    host = dequantize_int8_batch(q_np, s_np, n, block)
    np.testing.assert_array_equal(_bits(out.numpy()), _bits(host))
    if block == pallas_quant.QBLOCK:
        pallas = np.asarray(pallas_quant.dequantize_matrix(q_np, s_np, n))
        np.testing.assert_array_equal(_bits(out.numpy()), _bits(pallas))


# Dequantize's edge shapes (rows, n, block): rows after the first off the
# 16-byte grid (n % 4 = 1, 2, 3, 0), the top-k tier lengths under
# int8(1024), and blocks that are no multiple of 16 or 4.
DEQUANT_EDGES = [(3, 25_449, 1024), (3, 25_451, 1024), (3, 25_452, 1024),
                 (4, 10_180, 1024), (4, 3817, 1024), (4, 1018, 1024),
                 (5, 3001, 1000), (5, 2999, 7), (2, 3, 1)]


@pytest.mark.parametrize("rows,n,block", DEQUANT_EDGES)
def test_dequantize_plain_at_edge_shapes(rows, n, block):
    """The plain version at the CUDA kernel's edge shapes, bitwise against
    numpy and (block 1024) the Pallas kernel."""
    q_np, s_np = quantize_int8_batch(_mat(rows, n), block)
    out = quant_ops.dequantize(torch.from_numpy(q_np),
                               torch.from_numpy(s_np), n, block)
    host = dequantize_int8_batch(q_np, s_np, n, block)
    np.testing.assert_array_equal(_bits(out.numpy()), _bits(host))
    if block == pallas_quant.QBLOCK:
        pallas = np.asarray(pallas_quant.dequantize_matrix(q_np, s_np, n))
        np.testing.assert_array_equal(_bits(out.numpy()), _bits(pallas))


@pytest.mark.parametrize("rows,n,block,offset",
                         [(*e, False) for e in DEQUANT_EDGES]
                         + [(5, 2999, 7, True), (65_537, 9, 7, False)])
def test_dequantize_edges_on_the_card(rows, n, block, offset):
    """The CUDA kernel at the edge shapes, rows past a grid's 65,535, and
    codes whose base is off the 16-byte grid (a row of a larger buffer),
    bitwise against the plain version and numpy."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these checks "
                    "on the card")
    q_np, s_np = quantize_int8_batch(_mat(rows, n), block)
    dev = torch.device("cuda")
    q = torch.from_numpy(q_np).to(dev)
    if offset:
        buf = torch.zeros((rows + 1, q.shape[1]), dtype=torch.int8,
                          device=dev)
        buf[1:] = q
        q = buf[1:]
        assert q.data_ptr() % 16
    got = quant_ops.dequantize(q, torch.from_numpy(s_np).to(dev), n,
                               block).cpu()
    host = dequantize_int8_batch(q_np, s_np, n, block)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(host))


# The quantize kernel's plan (ops.quantize_plan): every (row, block) is
# taken by exactly one group of lanes over the grid-stride loop, every
# value of a block by exactly one (lane, unit, element), and the route at
# the paths' shapes.
PLAN_SHAPES = [(204_800, 16, 16), (1_024_000, 64, 64), (5_120_000, 64, 64),
               (204_800, 1600, 1600), (204_800, 5504, 5504),
               (1, 25_450, 1024), (16, 25_450, 1024), (1, 140_570_352, 1024),
               (1, 2, 256), (1, 2, 1024), (256, 256, 256), (256, 256, 1024),
               (2, 3, 1), (5, 2999, 7), (5, 3001, 1000), (65_537, 9, 7),
               (3, 20_005, 10_000)]


def _blocks_taken(p, total: int) -> np.ndarray:
    """How often the grid-stride loop of ``p`` takes each block: CTA c
    takes blocks base .. base + per_cta - 1 for base = c * per_cta, then
    every grid * per_cta further, while base < total (wide: block c)."""
    taken = np.zeros(total, np.int64)
    step = p.grid * p.per_cta
    for c in range(p.grid):
        first = np.arange(c * p.per_cta, total, step)
        for lane_group in range(p.per_cta):
            g = first + lane_group
            np.add.at(taken, g[g < total], 1)
    return taken


@pytest.mark.parametrize("rows,n,block", PLAN_SHAPES)
def test_quantize_plan_covers_each_block_once(rows, n, block):
    p = quant_ops.quantize_plan(rows, n, block, True)
    total = rows * -(-n // block)
    assert p.grid <= max(total, quant_ops.SMS * quant_ops.CTAS_A_SM)
    if p.route == "wide":
        assert (p.per_cta, p.grid) == (1, total) and block > \
            quant_ops.ROW_MAX
        return
    assert (p.lanes, p.units) in quant_ops.QUANT_KERNELS
    assert p.lanes * p.per_cta == quant_ops.QUANT_THREADS
    assert p.grid == min(-(-total // p.per_cta),
                         quant_ops.SMS * quant_ops.CTAS_A_SM)
    if total <= 1 << 22:
        assert (_blocks_taken(p, total) == 1).all()
    # value j of a block: element e of unit u of lane l, j = 4 (u G + l) + e
    j = np.array([4 * (u * p.lanes + lane) + e for lane in range(p.lanes)
                  for u in range(p.units) for e in range(4)])
    assert sorted(j) == list(range(4 * p.lanes * p.units))
    assert 4 * p.lanes * p.units >= block


@pytest.mark.parametrize("block", list(range(1, 260)) + [
    700, 768, 769, 1000, 1024, 1025, 1536, 1537, 1600, 2048, 2049, 4096,
    4097, 5504, 8192, 8193])
def test_quantize_plan_takes_the_fewest_lanes_and_units(block):
    """A few rows (short): one unit a lane, as many lanes as the block's
    units rounded up to a power of two, at most 256 (then the fewest
    units).  Rows past the card's threads: narrow blocks' units rounded up
    to a power of two, split as evenly as powers of two allow (lanes >=
    units); row blocks one warp while 8 units hold the block, else the
    fewest lanes, then the fewest units of ROW_UNITS."""
    short = quant_ops.quantize_plan(7, 3 * block, block, True)
    p = quant_ops.quantize_plan(10**6, 3 * block, block, True)
    if block > quant_ops.ROW_MAX:
        assert short.route == p.route == "wide"
        return
    assert short.route == "short" and 4 * short.lanes * short.units >= block
    if short.lanes < quant_ops.QUANT_THREADS:
        assert short.units == 1
        assert short.lanes == 1 or 4 * short.lanes // 2 < block
    else:
        fewer = [u for u in (1,) + quant_ops.ROW_UNITS if u < short.units]
        assert not fewer or 4 * 256 * fewer[-1] < block
    assert 4 * p.lanes * p.units >= block
    if block <= quant_ops.NARROW_MAX:
        assert p.route == "narrow"
        assert p.lanes in (p.units, 2 * p.units)
        assert p.lanes * p.units == 1 or 2 * p.lanes * p.units < block
    else:
        assert p.route == "row" and p.lanes >= 32
        assert p.lanes == 32 or 4 * 8 * p.lanes // 2 < block
        smaller = [u for u in quant_ops.ROW_UNITS if u < p.units]
        assert not smaller or 4 * p.lanes * smaller[-1] < block


# (rows, n, block, aligned) -> (route, lanes, units, vector): phase 14's
# four widths, the wire path (one client, and 16 rows whose starts are
# off the 16-byte grid), LM-FL's delta, wire_bench's rows.
PLAN_ROUTES = [
    ((204_800, 16, 16, True), ("narrow", 2, 2, True)),
    ((1_024_000, 64, 64, True), ("narrow", 4, 4, True)),
    ((204_800, 1600, 1600, True), ("row", 64, 8, True)),
    ((204_800, 5504, 5504, True), ("row", 256, 6, True)),
    ((704_512, 1600, 1600, True), ("row", 64, 8, True)),
    ((4, 1600, 1600, True), ("short", 256, 2, True)),
    ((128, 1600, 1600, True), ("short", 256, 2, True)),
    ((1, 25_450, 1024, True), ("short", 256, 1, True)),
    ((16, 25_450, 1024, False), ("short", 256, 1, False)),
    ((1, 140_570_352, 1024, True), ("row", 32, 8, True)),
    ((64, 1 << 20, 1024, True), ("row", 32, 8, True)),
    ((1, 2, 256, True), ("short", 64, 1, True)),
    ((1, 2, 1024, True), ("short", 256, 1, True)),
    ((256, 256, 256, True), ("short", 64, 1, True)),
    ((256, 256, 1024, True), ("short", 256, 1, True)),
    ((5, 2999, 7, True), ("short", 2, 1, False)),
]


@pytest.mark.parametrize("args,want", PLAN_ROUTES)
def test_quantize_plan_routes_at_the_paths_shapes(args, want):
    p = quant_ops.quantize_plan(*args)
    assert (p.route, p.lanes, p.units, p.vector) == want


def test_quantize_alignment_is_every_block_start_on_the_16_byte_grid():
    buf = torch.zeros(4 * 25_452 + 1)
    x = buf[:4 * 25_452].view(4, 25_452)
    assert quant_ops.is_aligned(x, 1024)
    assert not quant_ops.is_aligned(x, 1022)        # block % 4
    assert not quant_ops.is_aligned(buf[1:].view(4, 25_452), 1024)
    assert not quant_ops.is_aligned(buf[:4 * 25_450].view(4, 25_450), 1024)
    assert quant_ops.is_aligned(buf[:25_450].view(1, 25_450), 1024)


# Quantize's edge cases on the card (rows, n, block, offset), as
# chip_smoke.py's QUANT_EDGES: n % 4 = 1, 2, 3 and 0 over several rows,
# blocks 1, 7 and 1000, 65,537 rows, x one float off the 16-byte grid,
# and block sizes reaching each kernel of ops.QUANT_KERNELS and the wide
# route, over a few rows (short) and over more than the card's threads
# hold (narrow, row), by scalar and vector loads.
QUANT_EDGE_BLOCKS = (4, 7, 16, 32, 64, 128, 256, 512, 700, 1024, 1536,
                     2048, 3000, 4096, 5504, 8192, 10_000)


def _rows_past_the_card(block: int) -> int:
    """Rows of 3 blocks that need more threads than the card holds at one
    float4 unit a lane (up to 256 lanes a block): a call paced by its
    bytes, which takes the narrow or row route, not the short one."""
    spread = min(256, 1 << (-(-block // 4) - 1).bit_length())
    return 132 * 8 * 256 // (3 * spread) + 1


QUANT_EDGES = ([(3, 25_449, 1024, 0), (3, 25_450, 1024, 0),
                (3, 25_451, 1024, 0), (3, 25_452, 1024, 0), (2, 3, 1, 0),
                (5, 2999, 7, 0), (5, 3001, 1000, 0), (65_537, 9, 7, 0),
                (65_537, 64, 64, 0), (3, 4096, 1024, 1), (5, 2999, 7, 1),
                (4, 1600, 1600, 1)]
               + [(rows, 2 * b + 5, b, 0) for b in QUANT_EDGE_BLOCKS
                  for rows in (3, _rows_past_the_card(b))]
               + [(rows, 3 * b - 4, b, 0) for b in QUANT_EDGE_BLOCKS
                  for rows in (2, _rows_past_the_card(b))])


def test_quantize_edges_reach_every_kernel_by_both_loads():
    """The edge cases below reach every (lanes, units) kernel, the wide
    route, and vector and scalar loads (with x as the tests lay it out)."""
    reached = set()
    for rows, n, block, offset in QUANT_EDGES:
        aligned = (block % 4 == 0 and offset % 4 == 0
                   and (rows == 1 or n % 4 == 0))
        p = quant_ops.quantize_plan(rows, n, block, aligned)
        reached.add((p.route, p.lanes, p.units, p.vector))
    assert {(g, u) for r, g, u, _ in reached if r != "wide"} == set(
        quant_ops.QUANT_KERNELS)
    assert {r[0] for r in reached} == {"short", "narrow", "row", "wide"}
    assert {r[3] for r in reached if r[0] != "wide"} == {True, False}


@pytest.mark.parametrize("rows,n,block,offset", QUANT_EDGES)
def test_quantize_plain_at_edge_shapes(rows, n, block, offset):
    """The plain version at the CUDA kernel's edge shapes, bitwise against
    numpy."""
    mat = _mat(rows, n)
    q, s = quant_ops.quantize(torch.from_numpy(mat), block)
    q_np, s_np = quantize_int8_batch(mat, block)
    np.testing.assert_array_equal(q.numpy(), q_np)
    np.testing.assert_array_equal(_bits(s.numpy()), _bits(s_np))


@pytest.mark.parametrize("rows,n,block,offset", QUANT_EDGES)
def test_quantize_edges_on_the_card(rows, n, block, offset):
    """The CUDA kernel at the edge shapes, x laid ``offset`` floats into
    its buffer, bitwise against the plain version and numpy."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these checks "
                    "on the card")
    mat = _mat(rows, n)
    dev = torch.device("cuda")
    buf = torch.zeros(rows * n + offset, device=dev)
    buf[offset:] = torch.from_numpy(mat.reshape(-1)).to(dev)
    x = buf[offset:].view(rows, n)
    assert (x.data_ptr() % 16 == 0) == (offset == 0)
    q, s = quant_ops.quantize(x, block)
    q_ref, s_ref = quant_ref.quantize(x, block)
    assert torch.equal(q, q_ref)
    assert torch.equal(s.view(torch.int32), s_ref.view(torch.int32))
    q_np, s_np = quantize_int8_batch(mat, block)
    np.testing.assert_array_equal(q.cpu().numpy(), q_np)
    np.testing.assert_array_equal(_bits(s.cpu().numpy()), _bits(s_np))


def test_quantize_rounds_half_to_even_and_pads_with_zeros():
    # 127 * x / absmax lands exactly on .5 for these values; rint (not
    # floor(x + 0.5)) sends them to the even neighbour.
    x = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -2.5]], np.float32)
    q, s = quant_ref.quantize(torch.from_numpy(x), 8)
    assert s.item() == 1.0
    assert q.tolist() == [[127, 0, 2, 2, 0, -2, 0, 0]]


def test_quantize_rejects_bad_inputs():
    with pytest.raises(ValueError, match="2-D float32"):
        quant_ops.quantize(torch.zeros(4), 4)
    with pytest.raises(ValueError, match="block"):
        quant_ops.quantize(torch.zeros(1, 4), 0)
    with pytest.raises(ValueError, match="int8"):
        quant_ops.dequantize(torch.zeros(1, 8), torch.ones(1, 1), 8, 8)
    with pytest.raises(ValueError, match="does not fill"):
        quant_ops.dequantize(torch.zeros(1, 16, dtype=torch.int8),
                             torch.ones(1, 2), 8, 8)


# --------------------------------------------------------------------------
# Dispatch and device policy
# --------------------------------------------------------------------------
def test_kernel_backend_on_cpu_runs_the_plain_versions(monkeypatch):
    def _no_build(name):
        raise AssertionError(f"library {name!r} loaded for a CPU tensor")
    monkeypatch.setattr(_build, "load", _no_build)
    kernels.reset_launch_counts()
    stack, weights = _stack(4, 3000)
    port_agg.fedavg_stack(stack, weights, "kernel")
    assert port_wire.batch_backend() == "kernel"
    for spec in ("int8(1024)", "topk(0.1)|int8(1024)"):
        pipe = port_wire.parse_pipeline(spec)
        payloads = pipe.encode_batch([stack[0], stack[1]])
        port_wire.decode_payload_batch(payloads)
        pipe.decode(pipe.encode(stack[2], pipe.new_state()),
                    pipe.new_state())
    assert {"fedavg", "quantize", "dequantize", "topk_gather",
            "topk_scatter", "checksum"} <= set(kernels.launch_counts)
    assert not any(kernels.launch_counts.values()), kernels.launch_counts


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        port_device.resolve("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        port_agg.fedavg_stack(np.ones((2, 3), np.float32), None, "kernel",
                              device="cuda")
    pipe = port_wire.parse_pipeline("int8(1024)")
    with pytest.raises(RuntimeError, match="cuda"):
        pipe.encode_batch([np.ones(8, np.float32)], device="cuda")
    with port_device.use_device("cuda"):
        with pytest.raises(RuntimeError, match="cuda"):
            port_agg.fedavg_stack(np.ones((2, 3), np.float32))
    assert port_device.default_device().type == "cpu"


def _launch_fails(*args, **kwargs):
    raise RuntimeError("dequantize_i8_f32 launch failed: cudaError_t 98")


def test_kernel_failure_in_decode_raises_not_degrades(monkeypatch):
    stack, _ = _stack(3, 3000)
    pipe = port_wire.parse_pipeline("int8(1024)")
    payloads = pipe.encode_batch(list(stack))
    monkeypatch.setattr(quant_ops, "dequantize", _launch_fails)
    with pytest.raises(kernels.KernelError, match="cudaError_t 98"):
        port_wire.decode_payload_batch(payloads)
    with pytest.raises(kernels.KernelError, match="cudaError_t 98"):
        port_wire.decode_payload_batch(payloads[:1])    # per-item path
    with pytest.raises(kernels.KernelError, match="cudaError_t 98"):
        pipe.decode(payloads[0])


def test_launch_error_code_raises_kernel_error(monkeypatch):
    class _Lib:
        @staticmethod
        def fam_error_string(rc):
            return b"invalid device function"
    monkeypatch.setitem(_build._LIBS, "fam", _Lib)
    _build.check(0, "fam", "fam_f32")
    with pytest.raises(kernels.KernelError,
                       match="fam_f32 launch failed: cudaError_t 98 "
                             r"\(invalid device function\)"):
        _build.check(98, "fam", "fam_f32")


def test_build_keys_libraries_by_source_and_raises_without_nvcc(
        tmp_path, monkeypatch):
    src = tmp_path / "k.cu"
    src.write_text("// one")
    monkeypatch.setattr(_build, "_PKG", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setitem(_build.SOURCES, "k", "k.cu")
    first = _build.library_path("k")
    src.write_text("// two")
    assert _build.library_path("k") != first

    def _no_nvcc():
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(_build, "_nvcc", _no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build(["k"])
    (tmp_path / "out").mkdir()
    _build.library_path("k").touch()
    assert _build.build(["k"]) == {"k": 0.0}   # up to date: nothing runs


def test_library_path_hashes_the_headers_beside_the_source(tmp_path,
                                                        monkeypatch):
    """An edited or added header under a family's ``csrc/`` rebuilds its
    library; a family without headers keeps the key of its source and
    flags alone."""
    csrc = tmp_path / "fam" / "csrc"
    csrc.mkdir(parents=True)
    (csrc / "fam.cu").write_text('#include "util.cuh"\n')
    (csrc / "util.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "_PKG", tmp_path)
    monkeypatch.setitem(_build.SOURCES, "fam", "fam/csrc/fam.cu")
    first = _build.library_path("fam")
    assert _build.library_path("fam") == first
    (csrc / "util.cuh").write_text("// v2\n")
    second = _build.library_path("fam")
    assert second != first
    (csrc / "extra.h").write_text("// new\n")
    assert _build.library_path("fam") != second
    (csrc / "util.cuh").unlink()
    (csrc / "extra.h").unlink()
    flags = " ".join(_build.NVCC_FLAGS).encode()
    digest = hashlib.sha256(b'#include "util.cuh"\n' + flags).hexdigest()
    assert _build.library_path("fam").name == f"fam-{digest[:16]}.so"


def test_library_path_hashes_the_shared_headers_a_source_includes(
        tmp_path, monkeypatch):
    """An edited shared header (``kernels/csrc/``) rebuilds every family
    that includes it, directly or through another shared header, and no
    other; a header beside a source shadows a shared one of its name."""
    shared = tmp_path / _build.SHARED
    shared.mkdir()
    (shared / "prims.cuh").write_text('#include "maps.h"\n// v1\n')
    (shared / "maps.h").write_text("// v1\n")
    for fam, text in (("one", '#include "prims.cuh"\n'),
                      ("two", '#  include "maps.h"\n'),
                      ("three", '#include "local.cuh"\n')):
        csrc = tmp_path / fam / "csrc"
        csrc.mkdir(parents=True)
        (csrc / f"{fam}.cu").write_text(text)
        monkeypatch.setitem(_build.SOURCES, fam, f"{fam}/csrc/{fam}.cu")
    (tmp_path / "three" / "csrc" / "local.cuh").write_text("// local\n")
    monkeypatch.setattr(_build, "_PKG", tmp_path)
    keys = {fam: _build.library_path(fam) for fam in ("one", "two", "three")}
    (shared / "maps.h").write_text("// v2\n")
    after = {fam: _build.library_path(fam) for fam in keys}
    assert after["one"] != keys["one"] and after["two"] != keys["two"]
    assert after["three"] == keys["three"]
    (shared / "prims.cuh").write_text('#include "maps.h"\n// v2\n')
    again = {fam: _build.library_path(fam) for fam in keys}
    assert again["one"] != after["one"]
    assert again["two"] == after["two"] and again["three"] == keys["three"]
    (shared / "local.cuh").write_text("// shadowed\n")
    assert _build.library_path("three") == keys["three"]


def test_tma_families_hash_the_shared_hopper_headers():
    """The families fed by TMA (the two that issue wgmma, and fedavg's
    tall route) include the shared Hopper primitives and tensor-map
    helper; the others include neither."""
    names = {fam: [h.name for h in _build._shared_headers(
        [_build._PKG / src])] for fam, src in _build.SOURCES.items()}
    for fam in ("flash_attention", "mlstm", "fedavg"):
        assert names[fam] == ["hopper.cuh", "tensor_map.h"], fam
    assert not any(names[fam] for fam in ("quantize", "topk", "checksum"))


# --------------------------------------------------------------------------
# On the card: each kernel against its plain version (skipped without one)
# --------------------------------------------------------------------------
def test_cuda_kernels_match_plain_versions_bitwise():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check "
                    "on the card")
    dev = torch.device("cuda")
    # fedavg by each route, tile and stage size: the path's short stacks
    # (wide), the flow fleets' (tma), strides off the 16-byte grid and a
    # base one float into its buffer (cp_async), the first N of each tile.
    routes = set()
    for k, n, offset in [(16, 25450, 0), (12, 25450, 0), (32, 2048, 0),
                         (1, 7, 0), (64, 67_584, 0), (188, 2048, 0),
                         (1875, 2048, 0), (190, 2050, 0), (1875, 2050, 0),
                         (300, 2048, 1), (64, 2100, 0), (600, 4196, 0),
                         (64, 8390, 0), (600, 16_772, 0), (600, 16_774, 0)]:
        stack, weights = _stack(k, n)
        w = np.asarray(weights, np.float32)
        w = torch.from_numpy(w / w.sum())
        x = torch.from_numpy(stack)
        buf = torch.zeros(k * n + offset, device=dev)
        buf[offset:] = x.reshape(-1).to(dev)
        on_card, w_card = buf[offset:].view(k, n), w.to(dev)
        routes.add(fedavg_ops.plan(
            k, n, fedavg_ops.is_aligned(on_card, w_card)).route)
        got = fedavg_ops.fedavg(on_card, w_card).cpu()
        want = fedavg_ref.fedavg(x, w)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        host = ref_agg.fedavg_stack(stack, weights, backend="numpy")
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(host))
    assert routes == set(fedavg_ops.ROUTES)
    stack, weights = _stack(16, 25450)
    w = np.asarray(weights, np.float32)
    w = torch.from_numpy(w / w.sum())
    x = torch.from_numpy(stack)
    for block in (1024, 512):
        q, s = quant_ops.quantize(x.to(dev), block)
        q_ref, s_ref = quant_ref.quantize(x, block)
        assert torch.equal(q.cpu(), q_ref)
        assert torch.equal(s.cpu().view(torch.int32),
                           s_ref.view(torch.int32))
        out = quant_ops.dequantize(q, s, x.shape[1], block).cpu()
        assert torch.equal(out.view(torch.int32), quant_ref.dequantize(
            q_ref, s_ref, x.shape[1], block).view(torch.int32))


# The pod route on the card: odd N (every column alone), a base one element
# off the 16-byte grid (a head, vectors and a tail), each pair of dtypes
# the pod aggregation makes, K past one chunk of rows, and a bf16 stack
# past 2^31 bytes (64-bit indices).
POD_CARD_CASES = [(torch.bfloat16, torch.bfloat16, 4, 1001, 0),
                  (torch.bfloat16, torch.bfloat16, 4, 4096, 1),
                  (torch.float16, torch.float16, 3, 4096, 1),
                  (torch.float32, torch.float32, 2, 4099, 0),
                  (torch.float32, torch.bfloat16, 4, 4096, 1),
                  (torch.float32, torch.bfloat16, 2, 1001, 0),
                  (torch.bfloat16, torch.float32, 5, 4096, 1),
                  (torch.bfloat16, torch.bfloat16, 33, 2048, 0),
                  (torch.bfloat16, torch.bfloat16, 2, (1 << 30) + 3, 0)]


@pytest.mark.parametrize("dtype,cast_to,k,n,offset", POD_CARD_CASES)
def test_fedavg_pod_route_on_the_card(dtype, cast_to, k, n, offset):
    """The pod route's kernel bitwise against its plain version on the
    card, one launch under its own count."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these checks "
                    "on the card")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(k * n + offset)
    buf = torch.empty(k * n + offset, dtype=dtype, device=dev)
    buf.copy_(torch.randn(k * n + offset, generator=gen, device=dev))
    stack = buf[offset:].view(k, n)
    assert (stack.data_ptr() % 16 != 0) == bool(offset)
    w = torch.rand(k, generator=gen, device=dev) + 0.5
    w /= w.sum()
    before = (kernels.launch_counts["fedavg"],
              kernels.launch_counts["fedavg_pods"])
    got = fedavg_ops.fedavg(stack, w, cast_to=cast_to)
    assert (kernels.launch_counts["fedavg"],
            kernels.launch_counts["fedavg_pods"]) == (before[0] + 1,
                                                      before[1] + 1)
    want = fedavg_ref.fedavg(stack, w, cast_to=cast_to)
    assert _same_bits(got, want)
