"""The JAX package's random streams, drawn on the host in numpy.

The JAX package draws every random number it uses (the initial latent, the
img2img posterior sample, masked-content noise, the stochastic schedulers'
step noise, the trainers' timesteps, noise and initial LoRA factors) from
``jax.random`` with the default threefry2x32 key. This module makes the
same numbers without jax: numpy uint32 arithmetic that follows jax's
``jax_threefry_partitionable=True`` mode, the default since jax 0.5
(``jax/_src/prng.py``: ``threefry_seed``, ``_threefry_split_foldlike``,
``threefry_fold_in``, ``_threefry_random_bits_partitionable``), and
``jax/_src/random.py``'s ``uniform``, ``normal`` and ``randint``.

A key is a (2,) uint32 array, the raw data of ``jax.random.PRNGKey``, so a
key made by jax passes through ``np.asarray``. Bits are equal to jax's;
``normal`` in f32 lies within 1e-6 of jax's on the CPU (the inverse error
function is XLA's f32 polynomial, evaluated with fused multiply-adds; the
rest of the difference is XLA's own ``log1p``). bf16 draws take jax's
8-bit path and are rounded to bf16, returned as f32.

Every array stays numpy uint32: no Python integer enters the arithmetic, so
additions and shifts wrap at 32 bits as they do in XLA.
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np

Shape = Union[int, Sequence[int]]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)

# XLA's f32 inverse error function (M. Giles, "Approximating the erfinv
# function"): coefficients highest degree first, for w = -log1p(-x²) < 5
# (in w - 2.5) and for w ≥ 5 (in √w - 3).
_ERFINV_SMALL = np.array([2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                          -4.39150654e-06, 0.00021858087, -0.00125372503,
                          -0.00417768164, 0.246640727, 1.50140941], np.float32)
_ERFINV_LARGE = np.array([-0.000200214257, 0.000100950558, 0.00134934322,
                          -0.00367342844, 0.00573950773, -0.0076224613,
                          0.00943887047, 1.00167406, 2.83297682], np.float32)


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if np.ndim(shape) == 0 else tuple(int(d) for d in shape)


def _key(key) -> Tuple[np.ndarray, np.ndarray]:
    key = np.asarray(key)
    if key.shape != (2,) or key.dtype != np.uint32:
        raise TypeError(f"a key is a (2,) uint32 array, got {key.dtype}{key.shape}")
    return key[:1], key[1:]


def threefry2x32(k1: np.ndarray, k2: np.ndarray, x1: np.ndarray,
                 x2: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash of the counter pairs (x1, x2) under the key
    (k1, k2), 20 rounds, all uint32 (``prng.py:_threefry2x32_lowering``)."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    y0 = x1 + ks[0]
    y1 = x2 + ks[1]
    for r in range(5):
        for rot in _ROTATIONS[r % 2]:
            y0 = y0 + y1
            y1 = (y1 << np.uint32(rot)) | (y1 >> np.uint32(32 - rot))
            y1 = y0 ^ y1
        y0 = y0 + ks[(r + 1) % 3]
        y1 = y1 + ks[(r + 2) % 3] + np.uint32(r + 1)
    return y0, y1


def _iota_2x32(shape: Tuple[int, ...]) -> Tuple[np.ndarray, np.ndarray]:
    """The flat index of every element as (high, low) uint32 halves."""
    counts = np.arange(int(np.prod(shape, dtype=np.int64)), dtype=np.uint64).reshape(shape)
    return ((counts >> np.uint64(32)).astype(np.uint32),
            (counts & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def PRNGKey(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` with x64 off: the seed as a 32-bit
    integer (negative and larger seeds wrap), in the key's second word."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


def split(key, num: Shape = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: (*num, 2) keys, the hash of each
    key's flat index (the fold-like split)."""
    k1, k2 = _key(key)
    b1, b2 = threefry2x32(k1, k2, *_iota_2x32(_shape(num)))
    return np.stack([b1, b2], axis=-1)


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``: the hash of the pair (0, data)."""
    k1, k2 = _key(key)
    b1, b2 = threefry2x32(k1, k2, np.zeros(1, np.uint32),
                         np.array([int(data) & 0xFFFFFFFF], np.uint32))
    return np.concatenate([b1, b2])


_UINTS = {8: np.uint8, 16: np.uint16, 32: np.uint32}


def bits(key, shape: Shape = (), width: int = 32) -> np.ndarray:
    """``jax.random.bits(key, shape, uint{width})`` for widths 8, 16 and 32:
    each element hashes its flat index; the two words are xored and, below
    32 bits, truncated."""
    if width not in _UINTS:
        raise ValueError(f"width must be 8, 16 or 32, got {width}")
    k1, k2 = _key(key)
    b1, b2 = threefry2x32(k1, k2, *_iota_2x32(_shape(shape)))
    return (b1 ^ b2).astype(_UINTS[width])


def _check_dtype(dtype: str) -> None:
    if dtype not in ("float32", "bfloat16"):
        raise TypeError(f"dtype must be 'float32' or 'bfloat16', got {dtype!r}")


def round_bf16(x: np.ndarray) -> np.ndarray:
    """f32 values rounded to the nearest bf16 (ties to even), kept in f32."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    rounding = np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))
    return ((u + rounding) & np.uint32(0xFFFF0000)).view(np.float32)


def uniform(key, shape: Shape = (), dtype="float32", minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform``: random mantissa bits under the exponent of
    1.0, minus 1, scaled into [minval, maxval). f32 takes 23 of 32 bits; bf16
    takes 7 of 8 bits (jax draws at least 8 bits) and is returned as f32."""
    _check_dtype(dtype)
    if dtype == "float32":
        u = bits(key, shape, 32) >> np.uint32(9) | np.uint32(0x3F800000)
        floats = u.view(np.float32) - np.float32(1.0)
        lo, hi = np.float32(minval), np.float32(maxval)
        return np.maximum(lo, floats * (hi - lo) + lo)
    u = bits(key, shape, 8).astype(np.uint32) >> np.uint32(1) | np.uint32(0x3F80)
    floats = (u << np.uint32(16)).view(np.float32) - np.float32(1.0)
    lo = round_bf16(np.float32(minval))
    hi = round_bf16(np.float32(maxval))
    span = round_bf16(hi - lo)
    return np.maximum(lo, round_bf16(round_bf16(floats * span) + lo))


def _horner_fma(coeffs: np.ndarray, w: np.ndarray) -> np.ndarray:
    # each step is an f32 fused multiply-add: the f32 product is exact in
    # f64, and the sum is rounded once (to f64, then to f32)
    p = np.full(w.shape, coeffs[0], np.float32)
    w64 = w.astype(np.float64)
    for c in coeffs[1:]:
        p = (p.astype(np.float64) * w64 + np.float64(c)).astype(np.float32)
    return p


def erfinv_f32(x: np.ndarray) -> np.ndarray:
    """XLA's f32 inverse error function (``ErfInv32``)."""
    x = np.asarray(x, np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        w = -np.log1p(-(x * x))
        small = w < np.float32(5.0)
        arg = np.where(small, w - np.float32(2.5),
                       np.sqrt(np.maximum(w, np.float32(0.0))) - np.float32(3.0))
        p = np.where(small, _horner_fma(_ERFINV_SMALL, arg),
                     _horner_fma(_ERFINV_LARGE, arg))
        return np.where(np.abs(x) == np.float32(1.0), x * np.float32(np.inf), p * x)


def normal(key, shape: Shape = (), dtype="float32") -> np.ndarray:
    """``jax.random.normal``: √2·erfinv(u) for u uniform on
    [nextafter(-1, 0), 1) in the draw's dtype. bf16 is returned as f32."""
    _check_dtype(dtype)
    if dtype == "float32":
        lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
        u = uniform(key, shape, "float32", lo, 1.0)
        return np.float32(np.sqrt(2)) * erfinv_f32(u)
    # bf16 erfinv is the f32 one rounded to bf16; so is its product with √2
    u = uniform(key, shape, "bfloat16", -1.0 + 2.0 ** -8, 1.0)
    return round_bf16(round_bf16(np.float32(np.sqrt(2))) * round_bf16(erfinv_f32(u)))


def randint(key, shape: Shape, minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint`` for int32: two 32-bit draws from the split
    key folded into [minval, maxval) by jax's modular multiply, whose
    uint32 products wrap as they do in XLA."""
    shape = _shape(shape)
    k1, k2 = split(key, 2)
    higher, lower = bits(k1, shape, 32), bits(k2, shape, 32)
    lo, hi = int(minval), int(maxval)
    span = np.uint32(1 if hi <= lo else (hi - lo) & 0xFFFFFFFF)
    multiplier = np.full(shape, np.uint32(2 ** 16) % span, np.uint32)
    multiplier = (multiplier * multiplier) % span
    offset = (higher % span) * multiplier + lower % span
    offset = offset % span
    return (np.int64(lo) + offset.astype(np.int64)).astype(np.int32)
