"""Legacy payload codecs: the single-stage wire formats.

The paper hex-encodes each weight before packetizing (lossless, 2x
inflation).  This keeps that as the faithful codec next to raw bytes
(lossless, 1x), blockwise int8 quantization (4x smaller, lossy) and top-k
sparsification.

These classes define the **headerless wire layouts** that
``TransportConfig(codec=...)`` has always produced; the composable wire
plane (``repro_torch.core.wire``) re-expresses each as a single-stage
pipeline (byte-identical on this path) and composes them with
``delta``/``ef`` stages and self-describing headers.

All codecs operate on a flat float32 vector in numpy, so the transport
layer never needs a device.  ``quantize_int8_batch`` /
``dequantize_int8_batch`` are the host oracle the CUDA quantize kernels
(``repro_torch.kernels.quantize``) equal bit for bit; ``topk_sparsify``
picks the kept indices on the host, and the ``topk`` wire stage moves the
values with the CUDA top-k kernels (``repro_torch.kernels.topk``).
"""

from __future__ import annotations

import binascii
import dataclasses
import struct

import numpy as np

_U32 = struct.Struct("!I")
_U64 = struct.Struct("!Q")

#: Upper bound on a *declared* (wire-supplied) vector length a decoder will
#: allocate for.  The sparse formats size their output from a header field,
#: not from the bytes actually present, so without a cap one crafted
#: payload can demand a u32-limit (~17 GiB) zero vector.  2**28 params
#: (1 GiB of float32) is far above any model this simulator ships; raise it
#: module-wide if you legitimately need more.
MAX_DECODE_PARAMS = 1 << 28


class Codec:
    """bytes <-> flat float32 vector."""

    name: str = "abstract"
    lossless: bool = True

    def encode(self, vec: np.ndarray) -> bytes:  # pragma: no cover
        raise NotImplementedError

    def decode(self, data: bytes) -> np.ndarray:  # pragma: no cover
        raise NotImplementedError


class RawCodec(Codec):
    """Little-endian float32 bytes. 4 bytes/param."""

    name = "raw"
    lossless = True

    def encode(self, vec: np.ndarray) -> bytes:
        return np.ascontiguousarray(vec, dtype="<f4").tobytes()

    def decode(self, data: bytes) -> np.ndarray:
        return np.frombuffer(data, dtype="<f4").copy()


class HexCodec(Codec):
    """The paper's codec: each weight converted to a hexadecimal
    representation (Algorithm I, `ConvertToHex`). 8 bytes/param."""

    name = "hex"
    lossless = True

    def encode(self, vec: np.ndarray) -> bytes:
        return binascii.hexlify(np.ascontiguousarray(vec, dtype="<f4").tobytes())

    def decode(self, data: bytes) -> np.ndarray:
        return np.frombuffer(binascii.unhexlify(data), dtype="<f4").copy()


# --------------------------------------------------------------------------
# Blockwise int8 quantization (absmax per block) — beyond-paper compression.
# --------------------------------------------------------------------------
def quantize_int8(vec: np.ndarray, block: int = 1024
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Return (int8 values, float32 per-block scales)."""
    vec = np.asarray(vec, dtype=np.float32)
    n = vec.size
    nb = -(-n // block)
    padded = np.zeros(nb * block, dtype=np.float32)
    padded[:n] = vec
    blocks = padded.reshape(nb, block)
    scales = np.maximum(np.abs(blocks).max(axis=1), 1e-12) / 127.0
    q = np.clip(np.rint(blocks / scales[:, None]), -127, 127).astype(np.int8)
    return q.reshape(-1), scales.astype(np.float32)


def dequantize_int8(q: np.ndarray, scales: np.ndarray, n: int,
                    block: int = 1024) -> np.ndarray:
    q = np.asarray(q, dtype=np.int8).astype(np.float32)
    nb = scales.size
    out = (q.reshape(nb, block) * scales[:, None]).reshape(-1)
    return out[:n]


def quantize_int8_batch(mat: np.ndarray, block: int = 1024
                        ) -> tuple[np.ndarray, np.ndarray]:
    """Row-wise :func:`quantize_int8` over an ``(N, P)`` matrix in one shot:
    returns ``(q (N, nb*block) int8, scales (N, nb) f32)``.

    Bit-identical to quantizing each row separately — every op (absmax
    reduce, divide, rint, clip) is per-block elementwise, so batching
    cannot change a single rounding decision.  The wire batch plane
    (``repro_torch.core.wire``) relies on that for its byte-identity contract.
    """
    mat = np.asarray(mat, dtype=np.float32)
    n_items, n = mat.shape
    nb = -(-n // block)
    if n == nb * block:
        padded = np.ascontiguousarray(mat)     # aligned: skip the pad copy
    else:
        padded = np.zeros((n_items, nb * block), dtype=np.float32)
        padded[:, :n] = mat
    blocks = padded.reshape(n_items * nb, block) if nb else \
        padded.reshape(0, block)
    if blocks.shape[0]:
        # max(row.max, -row.min) == |row|.max without materializing |row|.
        scales = np.maximum(blocks.max(axis=1), -blocks.min(axis=1))
        np.maximum(scales, 1e-12, out=scales)
        scales /= 127.0
        q = blocks / scales[:, None]
        np.rint(q, out=q)
        np.clip(q, -127, 127, out=q)
        q = q.astype(np.int8)
    else:
        scales = np.zeros(0, np.float32)
        q = blocks.astype(np.int8)
    return (q.reshape(n_items, nb * block),
            scales.astype(np.float32, copy=False).reshape(n_items, nb))


def dequantize_int8_batch(q: np.ndarray, scales: np.ndarray, n: int,
                          block: int = 1024) -> np.ndarray:
    """Row-wise :func:`dequantize_int8`: ``(N, nb*block) -> (N, n)``,
    bit-identical to per-row dequantization (one elementwise multiply)."""
    out = np.asarray(q, dtype=np.int8).astype(np.float32)
    n_items, nb = scales.shape
    view = out.reshape(n_items, nb, block)
    view *= np.asarray(scales, np.float32)[:, :, None]
    return out.reshape(n_items, nb * block)[:, :n]


@dataclasses.dataclass
class Int8Codec(Codec):
    """Wire layout: n(u64) block(u32) nb(u32) | scales f32[nb] | int8[nb*block]."""

    block: int = 1024
    name = "int8"
    lossless = False

    def encode(self, vec: np.ndarray) -> bytes:
        vec = np.asarray(vec, dtype=np.float32)
        q, scales = quantize_int8(vec, self.block)
        head = _U64.pack(vec.size) + _U32.pack(self.block) + _U32.pack(scales.size)
        return head + scales.astype("<f4").tobytes() + q.tobytes()

    def decode(self, data: bytes) -> np.ndarray:
        n = _U64.unpack_from(data, 0)[0]
        block = _U32.unpack_from(data, 8)[0]
        nb = _U32.unpack_from(data, 12)[0]
        off = 16
        scales = np.frombuffer(data, dtype="<f4", count=nb, offset=off)
        off += 4 * nb
        q = np.frombuffer(data, dtype=np.int8, count=nb * block, offset=off)
        return dequantize_int8(q, scales.astype(np.float32), n, block)


# --------------------------------------------------------------------------
# Top-k sparsification (delta transmission) — beyond-paper compression.
# --------------------------------------------------------------------------
def topk_indices(vec: np.ndarray, k: int) -> np.ndarray:
    """The sorted u32 indices of the ``k`` largest-|x| entries of ``vec``
    (the selection half of :func:`topk_sparsify`)."""
    vec = np.asarray(vec, dtype=np.float32)
    k = min(k, vec.size)
    if k <= 0:
        # argpartition's -k would select the WHOLE array for k=0.
        return np.zeros(0, dtype=np.uint32)
    idx = np.argpartition(np.abs(vec), -k)[-k:].astype(np.uint32)
    idx.sort()
    return idx


def topk_sparsify(vec: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    vec = np.asarray(vec, dtype=np.float32)
    idx = topk_indices(vec, k)
    return idx, vec[idx]


@dataclasses.dataclass
class TopKCodec(Codec):
    """Keep the k largest-magnitude entries. Wire: n(u64) k(u32) | idx u32[k]
    | vals f32[k]. Pair with the ``ef`` wire stage (residual error
    feedback, ``repro_torch.core.wire``) for convergence."""

    k_fraction: float = 0.01
    name = "topk"
    lossless = False

    def encode(self, vec: np.ndarray) -> bytes:
        vec = np.asarray(vec, dtype=np.float32)
        k = min(vec.size, max(1, int(vec.size * self.k_fraction)))
        idx, vals = topk_sparsify(vec, k)
        # Header k is the ACTUAL entry count: for an empty (or size < k)
        # vector, packing the requested k would make decode read past the
        # buffer.
        return (_U64.pack(vec.size) + _U32.pack(idx.size)
                + idx.astype("<u4").tobytes() + vals.astype("<f4").tobytes())

    def decode(self, data: bytes) -> np.ndarray:
        n = _U64.unpack_from(data, 0)[0]
        if n > MAX_DECODE_PARAMS:
            # The output is sized from this wire-supplied field, so it must
            # be bounded before np.zeros(n) (u32 indices also cannot
            # address beyond 2**32 by construction).
            raise ValueError(f"topk n={n} exceeds MAX_DECODE_PARAMS "
                             f"({MAX_DECODE_PARAMS})")
        k = _U32.unpack_from(data, 8)[0]
        idx = np.frombuffer(data, dtype="<u4", count=k, offset=12)
        vals = np.frombuffer(data, dtype="<f4", count=k, offset=12 + 4 * k)
        out = np.zeros(n, dtype=np.float32)
        out[idx] = vals
        return out


CODECS: dict[str, type] = {
    "raw": RawCodec, "hex": HexCodec, "int8": Int8Codec, "topk": TopKCodec,
}


def make_codec(name: str, **kw) -> Codec:
    return CODECS[name](**kw)
