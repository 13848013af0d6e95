"""JAX's default random numbers in numpy, for drawing ``spaa_tpu``'s
initial weights without JAX.

``spaa_tpu`` initialises a flax model from ``jax.random.PRNGKey(seed)``:
every parameter gets its own key, the root key folded with the SHA-1 of
its scope path and a per-scope counter (flax's ``LazyRng``), and its
initialiser turns that key into numbers with the Threefry-2x32 hash
(``jax_threefry_partitionable``, JAX's default). This module reproduces
those steps: keys and bits exactly, ``uniform`` exactly (XLA evaluates its
scale-and-shift as one fused multiply-add), ``normal`` exactly but for
under 2% of the values, which differ by at most 3 float32 ulps (XLA's
own ``log1p`` inside Giles' ``erf_inv`` polynomial). Keys are numpy
``uint32`` arrays of shape (2,).
"""

from __future__ import annotations

import hashlib

import numpy as np

_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# Giles' single-precision erf_inv polynomial, as XLA evaluates it
_ERFINV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                  -4.39150654e-06, 0.00021858087, -0.00125372503,
                  -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                  -0.00367342844, 0.00573950773, -0.0076224613,
                  0.00943887047, 1.00167406, 2.83297682)


def threefry2x32(key, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of counter pairs (x0, x1)."""
    k0, k1 = _U32(key[0]), _U32(key[1])
    ks = (k0, k1, _U32(k0 ^ k1 ^ _U32(0x1BD11BDA)))
    x = [np.asarray(x0, _U32) + ks[0], np.asarray(x1, _U32) + ks[1]]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = (x[1] << _U32(r)) | (x[1] >> _U32(32 - r))
                x[1] = x[0] ^ x[1]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + _U32(i + 1)
    return x


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``."""
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], _U32)


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``."""
    a, b = threefry2x32(key, np.zeros(1, _U32), np.array([data], _U32))
    return np.array([a[0], b[0]], _U32)


def param_key(root, path, counter: int) -> np.ndarray:
    """The key flax hands the initialiser of a parameter: ``root`` folded
    with the first 4 bytes of the SHA-1 of the scope ``path`` (module
    names from the root) and the scope's ``counter`` (1 for its first
    parameter, 2 for the next, ...)."""
    h = hashlib.sha1()
    for name in path:
        h.update(name.encode("utf-8"))
    h.update(counter.to_bytes((counter.bit_length() + 7) // 8, "big"))
    return fold_in(root, int.from_bytes(h.digest()[:4], "big"))


def random_bits(key, shape) -> np.ndarray:
    """``jax.random.bits(key, shape, uint32)``: the hash of the element's
    64-bit row-major index, its two words xored."""
    idx = np.arange(int(np.prod(shape)), dtype=np.uint64)
    b0, b1 = threefry2x32(key, (idx >> np.uint64(32)).astype(_U32),
                          (idx & np.uint64(0xFFFFFFFF)).astype(_U32))
    return (b0 ^ b1).reshape(shape)


def _fma32(a, b, c) -> np.ndarray:
    """float32 a * b + c rounded once (the product is exact in float64)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def uniform(key, shape, minval, maxval) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``: 23
    random mantissa bits under exponent 0, minus 1, scaled and shifted."""
    lo, hi = np.float32(minval), np.float32(maxval)
    bits = (random_bits(key, shape) >> _U32(9)) | _U32(0x3F800000)
    floats = bits.view(np.float32) - np.float32(1.0)
    return np.maximum(lo, _fma32(floats, hi - lo, lo))


def _erf_inv(x: np.ndarray) -> np.ndarray:
    f = np.float32
    w = -np.log1p(-x * x)
    small = w < f(5.0)
    w = np.where(small, w - f(2.5), np.sqrt(w) - f(3.0))
    p = np.where(small, f(_ERFINV_W_LT_5[0]), f(_ERFINV_W_GE_5[0]))
    for a, b in zip(_ERFINV_W_LT_5[1:], _ERFINV_W_GE_5[1:]):
        p = _fma32(p, w, np.where(small, f(a), f(b)))
    return p * x


def normal(key, shape, scale: float = 1.0) -> np.ndarray:
    """``jax.random.normal(key, shape, float32) * scale``, as a jitted
    initialiser computes it: erf_inv of a uniform draw on (-1, 1) times
    sqrt(2) * scale, the two constants folded into one float32."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0), dtype=np.float32)
    u = uniform(key, shape, lo, np.float32(1.0))
    return _erf_inv(u) * (np.float32(np.sqrt(2.0)) * np.float32(scale))
