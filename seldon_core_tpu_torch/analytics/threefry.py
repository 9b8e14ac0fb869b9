"""The JAX package's ``jax.random.normal(PRNGKey(seed), shape)`` in numpy,
for the port's VAE detector, whose score draws its eps from a fixed key.

``threefry2x32`` is JAX's Threefry-2x32 hash (20 rounds). With
``jax_threefry_partitionable`` on (JAX's default), the 32-bit random
word of element ``i`` (row-major) of a ``shape`` is ``x0 ^ x1`` where
``(x0, x1) = threefry2x32(key, (i >> 32, i & 0xffffffff))``: the word
of an element depends on its index alone, never on the shape.
``normal`` turns the words into float32 as JAX does: the top 23 bits as
a mantissa in [1, 2), minus 1, scaled onto [nextafter(-1, 0), 1), then
``sqrt(2) * erfinv(u)`` with the single-precision erfinv polynomial of
M. Giles ("Approximating the erfinv function"), the one XLA evaluates.
The random words equal JAX's bit for bit; the normals agree within a few
float32 ulps (XLA's own ``log1p`` and its fused multiply-adds round a
little differently from numpy's).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry2x32(key: Tuple[int, int], x0: np.ndarray, x1: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 of the counter words ``(x0, x1)`` (uint32 arrays of
    one shape) under ``key`` (two uint32 words)."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = x0.astype(np.uint32) + ks[0]
    x1 = x1.astype(np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def key_of_seed(seed: int) -> Tuple[int, int]:
    """``jax.random.PRNGKey(seed)``'s two words, for a seed in [0, 2**32)."""
    if not 0 <= int(seed) < 1 << 32:
        raise ValueError(f"seed {seed} outside [0, 2**32)")
    return 0, int(seed)


def random_bits(key: Tuple[int, int], shape: Sequence[int]) -> np.ndarray:
    """``jax.random.bits(key, shape)`` (uint32, partitionable layout)."""
    n = int(np.prod(shape, dtype=np.int64))
    idx = np.arange(n, dtype=np.uint64)
    with np.errstate(over="ignore"):
        x0, x1 = threefry2x32(key, (idx >> np.uint64(32)).astype(np.uint32),
                              (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    return (x0 ^ x1).reshape(tuple(shape))


_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
           -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
           -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erfinv32(x: np.ndarray) -> np.ndarray:
    """float32 erfinv by Giles' single-precision polynomial; +-inf at +-1."""
    x = np.asarray(x, dtype=np.float32)
    f32 = np.float32
    w = -np.log1p(-x * x)
    lt = w < f32(5.0)
    w = np.where(lt, w - f32(2.5), np.sqrt(w) - f32(3.0)).astype(np.float32)
    p = np.where(lt, f32(_W_LT_5[0]), f32(_W_GE_5[0])).astype(np.float32)
    w64 = w.astype(np.float64)
    for lo, hi in zip(_W_LT_5[1:], _W_GE_5[1:]):
        # Horner's step as one fused multiply-add: the product of two
        # float32 is exact in float64, then one rounding
        p = (np.where(lt, lo, hi).astype(np.float32).astype(np.float64)
             + p.astype(np.float64) * w64).astype(np.float32)
    out = p * x
    return np.where(np.abs(x) == f32(1.0), np.copysign(np.float32(np.inf), x), out
                    ).astype(np.float32)


def normal(seed: int, shape: Sequence[int]) -> np.ndarray:
    """``jax.random.normal(jax.random.PRNGKey(seed), shape)`` (float32)."""
    bits = random_bits(key_of_seed(seed), shape)
    f = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = np.maximum(lo, f * (np.float32(1.0) - lo) + lo)
    return (np.float32(np.sqrt(2.0)) * erfinv32(u)).astype(np.float32)


__all__ = ["erfinv32", "key_of_seed", "normal", "random_bits", "threefry2x32"]
