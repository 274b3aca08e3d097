"""Legacy payload codecs: the single-stage wire formats.

The paper hex-encodes each weight before packetizing (lossless, 2x
inflation).  This keeps that as the faithful codec next to raw bytes
(lossless, 1x) and blockwise int8 quantization (4x smaller, lossy).

These classes define the **headerless wire layouts** that
``TransportConfig(codec=...)`` has always produced; the composable wire
plane (``repro_torch.core.wire``) re-expresses each as a single-stage
pipeline (byte-identical on this path) and composes them with
``delta``/``ef`` stages and self-describing headers.

All codecs operate on a flat float32 vector in numpy, so the transport
layer never needs a device.  ``quantize_int8_batch`` /
``dequantize_int8_batch`` are the host oracle the CUDA quantize kernels
(``repro_torch.kernels.quantize``) equal bit for bit.  The ``topk`` codec
arrives with its kernel in a later slice of the port.
"""

from __future__ import annotations

import binascii
import dataclasses
import struct

import numpy as np

_U32 = struct.Struct("!I")
_U64 = struct.Struct("!Q")


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


CODECS: dict[str, type] = {
    "raw": RawCodec, "hex": HexCodec, "int8": Int8Codec,
}


def make_codec(name: str, **kw) -> Codec:
    return CODECS[name](**kw)
