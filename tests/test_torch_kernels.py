"""The port's kernels (plain PyTorch versions on the CPU) against the
reference's host numpy path and its Pallas kernels (interpret mode).

* fedavg: bitwise equal to ``repro.core.aggregation.fedavg_stack(...,
  "numpy")`` (the same float32 fold, no FMA); within ``rtol=atol=1e-6``
  of the Pallas kernel, which reduces over clients in a tree.
* quantize: bitwise equal to ``quantize_int8_batch`` at any block; against
  the Pallas kernel (block 1024) and its jnp oracle (other blocks) scales
  agree to 1 ULP and codes to one step.
* dequantize: bitwise equal to both.
* the ``"kernel"`` backends dispatch to the plain versions on CPU tensors
  (no library is built or loaded), and asking for ``cuda`` without a card
  raises.
"""

from __future__ import annotations

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
@pytest.mark.parametrize("n", [1, 1000, 16385, 25450])
@pytest.mark.parametrize("k", [1, 2, 5, 16])
def test_fedavg_plain_matches_numpy_bitwise_and_pallas(k, n):
    stack, weights = _stack(k, n)
    ours = port_agg.fedavg_stack(stack, weights, "kernel")
    host = ref_agg.fedavg_stack(stack, weights, backend="numpy")
    np.testing.assert_array_equal(_bits(ours), _bits(host))
    np.testing.assert_array_equal(
        _bits(port_agg.fedavg_stack(stack, weights, "numpy")), _bits(host))
    pallas = np.asarray(pallas_fedavg.fedavg_flat(stack, weights))
    np.testing.assert_allclose(ours, pallas, rtol=1e-6, atol=1e-6)


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
    assert kernels.launch_counts == {"fedavg": 0, "quantize": 0,
                                     "dequantize": 0, "topk_gather": 0,
                                     "topk_scatter": 0, "checksum": 0}


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


# --------------------------------------------------------------------------
# On the card: each kernel against its plain version (skipped without one)
# --------------------------------------------------------------------------
def test_cuda_kernels_match_plain_versions_bitwise():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check "
                    "on the card")
    dev = torch.device("cuda")
    stack, weights = _stack(16, 25450)
    w = np.asarray(weights, np.float32)
    w = torch.from_numpy(w / w.sum())
    x = torch.from_numpy(stack)
    got = fedavg_ops.fedavg(x.to(dev), w.to(dev)).cpu()
    assert torch.equal(got.view(torch.int32),
                       fedavg_ref.fedavg(x, w).view(torch.int32))
    for block in (1024, 512):
        q, s = quant_ops.quantize(x.to(dev), block)
        q_ref, s_ref = quant_ref.quantize(x, block)
        assert torch.equal(q.cpu(), q_ref)
        assert torch.equal(s.cpu().view(torch.int32),
                           s_ref.view(torch.int32))
        out = quant_ops.dequantize(q, s, x.shape[1], block).cpu()
        assert torch.equal(out.view(torch.int32), quant_ref.dequantize(
            q_ref, s_ref, x.shape[1], block).view(torch.int32))
