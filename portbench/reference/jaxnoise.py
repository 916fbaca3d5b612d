"""``jax.random.normal(jax.random.PRNGKey(seed), shape)`` in numpy, without jax.

The program draws its initial latents and its re-noising from the JAX
package's stream (threefry2x32 with ``jax_threefry_partitionable``, the
default since jax 0.5); the reference draws the same numbers here, from
the same seed, by jax's published algorithm: each element hashes its flat
index under the key, the two words are xored, 23 bits become a uniform on
[nextafter(-1, 0), 1), and the normal is sqrt(2)·erfinv of it, with XLA's
float32 erfinv polynomial (M. Giles).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_SMALL = np.array([2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                   0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
                   1.50140941], np.float32)
_LARGE = np.array([-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                   0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
                   2.83297682], np.float32)


def _threefry(k1, k2, x1, x2):
    ks = (k1, k2, k1 ^ k2 ^ np.uint32(0x1BD11BDA))
    y0, y1 = x1 + ks[0], x2 + ks[1]
    for r in range(5):
        for rot in _ROT[r % 2]:
            y0 = y0 + y1
            y1 = (y1 << np.uint32(rot)) | (y1 >> np.uint32(32 - rot))
            y1 = y0 ^ y1
        y0 = y0 + ks[(r + 1) % 3]
        y1 = y1 + ks[(r + 2) % 3] + np.uint32(r + 1)
    return y0, y1


def _poly(coeffs, w):
    p = np.full(w.shape, coeffs[0], np.float32)
    w64 = w.astype(np.float64)
    for c in coeffs[1:]:  # f32 fused multiply-adds
        p = (p.astype(np.float64) * w64 + np.float64(c)).astype(np.float32)
    return p


def normal(seed: int, shape: Sequence[int]) -> np.ndarray:
    """float32 standard normals, ``jax.random.normal(PRNGKey(seed), shape)``."""
    k1 = np.zeros(1, np.uint32)
    k2 = np.array([int(seed) & 0xFFFFFFFF], np.uint32)
    n = int(np.prod(shape, dtype=np.int64))
    idx = np.arange(n, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    b1, b2 = _threefry(k1, k2, hi, lo)
    bits = (b1 ^ b2) >> np.uint32(9) | np.uint32(0x3F800000)
    u = bits.view(np.float32) - np.float32(1.0)
    lo_v = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = np.maximum(lo_v, u * (np.float32(1.0) - lo_v) + lo_v)
    with np.errstate(divide="ignore", invalid="ignore"):
        w = -np.log1p(-(u * u))
        small = w < np.float32(5.0)
        arg = np.where(small, w - np.float32(2.5),
                       np.sqrt(np.maximum(w, np.float32(0.0))) - np.float32(3.0))
        p = np.where(small, _poly(_SMALL, arg), _poly(_LARGE, arg))
        x = np.where(np.abs(u) == np.float32(1.0), u * np.float32(np.inf), p * u)
    return (np.float32(np.sqrt(2)) * x).reshape(tuple(shape))
