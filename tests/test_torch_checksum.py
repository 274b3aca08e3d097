"""The port's ChunkSum-32 against the reference's.

Seeded byte strings of lengths 0, 1, 8191 (one weight period), 8192,
100,003 (ragged against the Pallas tile and the CUDA kernel's 16-byte
vectors) go through the reference's numpy oracle ``chunksum32_np``, its
Pallas kernel (``checksum_bytes``, interpret mode) and the port's
``checksum_bytes`` on the CPU (the plain PyTorch version); the empty
string only through the oracle, since the Pallas kernel cannot tile it.
The sums are integers mod 2**32, so the tolerance is exact.  A flipped
byte and two swapped neighbours change the checksum in all three.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.kernels.checksum.ops import (  # noqa: E402
    checksum_bytes as ref_checksum_bytes)
from repro.kernels.checksum.ref import (WEIGHT_PERIOD,  # noqa: E402
                                        chunksum32_np)
from repro_torch import device as port_device  # noqa: E402
from repro_torch.core import wire as port_wire  # noqa: E402
from repro_torch.kernels.checksum import ops as ck_ops  # noqa: E402
from repro_torch.kernels.checksum import ref as ck_ref  # noqa: E402

LENGTHS = [0, 1, 8191, 8192, 100_003]


@pytest.fixture(autouse=True)
def _cpu():
    with port_device.use_device("cpu"):
        yield


def _data(n: int) -> bytes:
    return np.random.default_rng(n).integers(0, 256, n,
                                             dtype=np.uint8).tobytes()


@pytest.mark.parametrize("n", LENGTHS)
def test_checksum_matches_reference_oracle_and_pallas(n):
    data = _data(n)
    ours = ck_ops.checksum_bytes(data, device="cpu")
    assert ours == chunksum32_np(np.frombuffer(data, np.uint8))
    assert ours == port_wire.chunksum32(data)
    if n:       # the reference's Pallas kernel cannot tile an empty buffer
        assert ours == ref_checksum_bytes(data)


@pytest.mark.parametrize("n", [2, 8192, 100_003])
def test_flipped_and_swapped_bytes_change_the_checksum(n):
    data = bytearray(_data(n))
    data[0], data[1] = 17, 200           # make the swap below a change
    base = ck_ops.checksum_bytes(bytes(data), device="cpu")
    flipped = bytearray(data)
    flipped[n // 2] ^= 0x01
    swapped = bytearray(data)
    swapped[0], swapped[1] = swapped[1], swapped[0]
    for other in (flipped, swapped):
        ours = ck_ops.checksum_bytes(bytes(other), device="cpu")
        assert ours != base
        assert ours == chunksum32_np(np.frombuffer(bytes(other), np.uint8))
        assert ours == ref_checksum_bytes(bytes(other))


def test_sums_wrap_mod_two_to_the_32():
    """A buffer long enough for B to pass 2**32 wraps exactly like the
    definition's int32 arithmetic, and the sums come back as int32 bits."""
    x = torch.full((70_000,), 255, dtype=torch.uint8)
    sums = ck_ops.chunksum32(x)
    assert sums.dtype == torch.int32 and sums.shape == (2,)
    w = np.arange(70_000, dtype=np.int64) % WEIGHT_PERIOD + 1
    b = int((w * 255).sum())
    assert b >= 1 << 32
    assert int(sums[1]) & 0xFFFFFFFF == b & 0xFFFFFFFF
    assert int(sums[0]) & 0xFFFFFFFF == 255 * 70_000
    assert ck_ref.combine(sums) == chunksum32_np(x.numpy())


def test_weight_period_is_the_reference_constant():
    assert ck_ref.WEIGHT_PERIOD == WEIGHT_PERIOD == 8191


def test_rejects_bad_inputs():
    with pytest.raises(ValueError, match="uint8"):
        ck_ops.chunksum32(torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="1-D"):
        ck_ops.chunksum32(torch.zeros((2, 2), dtype=torch.uint8))


def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check "
                    "on the card")
    for n in LENGTHS:
        data = _data(n)
        x = torch.from_numpy(np.frombuffer(data, np.uint8).copy()).cuda()
        assert torch.equal(ck_ops.chunksum32(x), ck_ref.chunksum32(x))
        assert ck_ops.checksum_bytes(data, device="cuda") == \
            chunksum32_np(np.frombuffer(data, np.uint8))
