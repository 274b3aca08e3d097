"""JAX's default random generator, reproduced in numpy for the draws the
reference's examples make: ``jax.random.PRNGKey``, ``split`` and
``normal`` under the threefry2x32 implementation with
``jax_threefry_partitionable`` on (JAX's default).

The keys and the random bits are bit for bit JAX's (threefry2x32 is
integer arithmetic).  ``normal`` maps the bits to ``(-1, 1)`` as JAX does
and applies the same float32 polynomial for ``erfinv`` (Giles'
approximation, XLA's ``ErfInv32``), with ``log1p`` taken in float64: the
draws lie within 3 ULP of JAX's (about 5% of them differ), which the
tests hold.  Used for the initial weights of the paper's quickstart MLP
(:func:`repro_torch.models.mlp.init_paper_mlp`), so that the port starts
where the reference's examples start without importing JAX.
"""

from __future__ import annotations

import numpy as np

_U32 = np.uint32
_F32 = np.float32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# XLA's ErfInv32 coefficients, for w = -log1p(-x^2) below 5 and above.
_ERFINV_LT5 = np.array([2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                        -4.39150654e-06, 0.00021858087, -0.00125372503,
                        -0.00417768164, 0.246640727, 1.50140941], _F32)
_ERFINV_GE5 = np.array([-0.000200214257, 0.000100950558, 0.00134934322,
                        -0.00367342844, 0.00573950773, -0.0076224613,
                        0.00943887047, 1.00167406, 2.83297682], _F32)

Key = tuple[np.uint32, np.uint32]


def key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)``: the seed's high and low words."""
    seed = int(seed) & ((1 << 64) - 1)
    return _U32(seed >> 32), _U32(seed & 0xFFFFFFFF)


def threefry2x32(k: Key, x0: np.ndarray, x1: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray]:
    """The threefry2x32 block cipher (20 rounds) on counter words."""
    ks = (_U32(k[0]), _U32(k[1]), _U32(k[0] ^ k[1] ^ _U32(0x1BD11BDA)))
    x = [x0.astype(_U32) + ks[0], x1.astype(_U32) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = ((x[1] << _U32(r)) | (x[1] >> _U32(32 - r))) ^ x[0]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + _U32(i + 1)
    return x[0], x[1]


def _counters(n: int) -> tuple[np.ndarray, np.ndarray]:
    c = np.arange(n, dtype=np.uint64)
    return ((c >> np.uint64(32)).astype(_U32),
            (c & np.uint64(0xFFFFFFFF)).astype(_U32))


def split(k: Key, num: int = 2) -> list[Key]:
    """``jax.random.split(k, num)``."""
    b0, b1 = threefry2x32(k, *_counters(num))
    return [(b0[i], b1[i]) for i in range(num)]


def bits(k: Key, n: int) -> np.ndarray:
    """``jax.random.bits(k, (n,), uint32)``."""
    b0, b1 = threefry2x32(k, *_counters(n))
    return b0 ^ b1


def _erfinv(x: np.ndarray) -> np.ndarray:
    w = (-np.log1p(-(x * x).astype(np.float64))).astype(_F32)
    lt = w < _F32(5)
    w = np.where(lt, w - _F32(2.5), np.sqrt(w) - _F32(3)).astype(_F32)
    p = np.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0]).astype(_F32)
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = (np.where(lt, c_lt, c_ge) + p * w).astype(_F32)
    return (p * x).astype(_F32)


def normal(k: Key, shape: tuple[int, ...]) -> np.ndarray:
    """``jax.random.normal(k, shape)`` in float32 (within 3 ULP)."""
    b = bits(k, int(np.prod(shape)))
    unit = ((b >> _U32(9)) | _U32(0x3F800000)).view(_F32) - _F32(1)
    lo = np.nextafter(_F32(-1), _F32(0))
    u = np.maximum(lo, unit * (_F32(1) - lo) + lo).astype(_F32)
    return (_F32(np.sqrt(2)) * _erfinv(u)).reshape(shape)
