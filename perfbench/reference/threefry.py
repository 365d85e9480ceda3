"""Host-side threefry2x32, a frozen copy for the benchmark's reference.

The key stream of ``jax.random`` (threefry2x32, partitionable layout)
in numpy uint32 arithmetic: ``PRNGKey``, ``split``, ``random_bits``,
``randint`` and ``uniform`` as bits, and ``normal`` as
``sqrt(2)·erf_inv(u)`` with XLA's f32 ``erf_inv``, ``log1p`` and
``log`` emulated in numpy float32.  The reference draws the k-means++
seeds and a SplitNN's initial parameters from the same seeds as the
system under test, so both start from the same numbers; the copy is
kept here so that a later change to the program cannot move the
yardstick.
"""
from __future__ import annotations

import numpy as np

__all__ = ["PRNGKey", "split", "random_bits", "randint", "uniform", "normal"]

_u32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << _u32(d)) | (x >> _u32(32 - d))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    """The threefry2x32 block function: key (2,) u32, counters x0/x1
    (same shape) u32 -> two u32 arrays of that shape."""
    k0, k1 = _u32(key[0]), _u32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _u32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x = [np.asarray(x0, _u32) + ks[0], np.asarray(x1, _u32) + ks[1]]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + _u32(i + 1)
    return x[0], x[1]


def PRNGKey(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for a seed in [0, 2^64)."""
    seed = int(seed)
    if not 0 <= seed < 2 ** 64:
        raise ValueError(f"seed must lie in [0, 2^64), got {seed}")
    return np.array([seed >> 32, seed & 0xFFFFFFFF], _u32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split``: (num, 2) u32 keys (partitionable layout:
    counter i is the 64-bit iota value i as (hi, lo) lanes)."""
    idx = np.arange(num, dtype=np.uint64)
    b0, b1 = threefry2x32(key, (idx >> np.uint64(32)).astype(_u32),
                          (idx & np.uint64(0xFFFFFFFF)).astype(_u32))
    return np.stack([b0, b1], axis=1)


def random_bits(key: np.ndarray, shape=()) -> np.ndarray:
    """``jax.random.bits(key, shape)`` (u32): threefry over the flat
    row-major iota counters, each 64-bit counter as (hi, lo) lanes, the
    two output lanes xored.  A scalar draw is counter (0, 0)."""
    shape = tuple(shape)
    idx = np.arange(int(np.prod(shape, dtype=np.int64)), dtype=np.uint64)
    b0, b1 = threefry2x32(key, (idx >> np.uint64(32)).astype(_u32),
                          (idx & np.uint64(0xFFFFFFFF)).astype(_u32))
    return (b0 ^ b1).reshape(shape)[()]


def randint(key: np.ndarray, shape, minval: int, maxval: int):
    """``jax.random.randint(key, shape, minval, maxval)``: int32 of
    ``shape`` (a numpy int32 scalar at shape ``()``).  ``maxval`` may be
    a traced-style value such as a client's valid row count; the
    arithmetic is the reference's, wrapping uint32 products included."""
    k1, k2 = split(key)
    hi, lo = random_bits(k1, shape), random_bits(k2, shape)
    span = _u32(1) if maxval <= minval else _u32(maxval - minval)
    with np.errstate(over="ignore"):
        mult = _u32(2 ** 16) % span
        mult = (mult * mult) % span
        off = ((hi % span) * mult + (lo % span)) % span
    return (np.int32(minval) + np.asarray(off).astype(np.int32))[()]


def uniform(key: np.ndarray, shape=(), minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``: the
    top 23 bits become the mantissa of a float in [1, 2), minus 1, then
    ``max(minval, f·(maxval − minval) + minval)`` in float32."""
    bits = (random_bits(key, shape) >> _u32(9)) | _u32(0x3F800000)
    f = np.asarray(bits, _u32).view(np.float32) - np.float32(1)
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, f * (hi - lo) + lo)[()]


def _fma(a, b, c) -> np.ndarray:
    """Fused multiply-add in float32 (the product and sum in float64,
    one rounding to float32), as XLA's CPU code contracts ``a·b + c``."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


# Cephes ``logf`` as XLA's CPU backend evaluates it: frexp, a shift to
# [sqrt(1/2) - 1, sqrt(2) - 1), a degree-8 polynomial in three FMA chains
_LOG_P = np.array([7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
                   -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
                   2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1],
                  np.float32)


def _log(x: np.ndarray) -> np.ndarray:
    f32 = np.float32
    m, e = np.frexp(np.maximum(x, f32(1.17549435e-38)))
    m, e = m.astype(f32), e.astype(f32)
    low = m < f32(0.707106781186547524)
    e = e - np.where(low, f32(1), f32(0))
    m = (m - f32(1)) + np.where(low, m, f32(0))
    m2 = m * m
    m3 = m2 * m
    p = _LOG_P
    y = _fma(_fma(p[0], m, p[1]), m, p[2])
    y1 = _fma(_fma(p[3], m, p[4]), m, p[5])
    y2 = _fma(_fma(p[6], m, p[7]), m, p[8])
    y = _fma(_fma(y, m3, y1), m3, y2) * m3
    y = _fma(f32(-2.12194440e-4), e, y)
    return _fma(f32(0.693359375), e, _fma(f32(-0.5), m2, m) + y)


# XLA's ``log1p``: Cephes' rational approximation below |x| = sqrt(2) - 1,
# ``log(1 + x)`` above
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)


def _log1p(x: np.ndarray) -> np.ndarray:
    f32 = np.float32
    num = den = np.zeros_like(x)
    for a, b in zip(_LOG1P_NUM, _LOG1P_DEN):
        num, den = _fma(num, x, f32(a)), _fma(den, x, f32(b))
    x2 = x * x
    small = x + _fma(f32(-0.5), x2, (x * x2) * (num / den))
    return np.where(np.abs(x) < f32(0.41421356237309504880), small,
                    _log(x + f32(1)))


# XLA's f32 erf_inv (M. Giles, "Approximating the erfinv function"): a
# degree-8 polynomial in w = -log1p(-x²), one set of coefficients below
# w = 5 and one above
_ERFINV_LT5 = np.array([2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                        -4.39150654e-06, 0.00021858087, -0.00125372503,
                        -0.00417768164, 0.246640727, 1.50140941],
                       np.float32)
_ERFINV_GE5 = np.array([-0.000200214257, 0.000100950558, 0.00134934322,
                        -0.00367342844, 0.00573950773, -0.0076224613,
                        0.00943887047, 1.00167406, 2.83297682], np.float32)


def erf_inv(x: np.ndarray) -> np.ndarray:
    """XLA's float32 ``erf_inv`` on its CPU backend, operation for
    operation in numpy float32 (inputs in (-1, 1))."""
    x = np.asarray(x, np.float32)
    w = -_log1p(x * -x)
    lt = w < np.float32(5)
    w = np.where(lt, w - np.float32(2.5), np.sqrt(w) - np.float32(3))
    p = np.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma(p, w, np.where(lt, c_lt, c_ge))
    return p * x


def normal(key: np.ndarray, shape=()) -> np.ndarray:
    """``jax.random.normal(key, shape, float32)``: ``sqrt(2)·erf_inv(u)``
    of a uniform on (nextafter(-1, 0), 1); where the emulated ``log``
    rounds otherwise than XLA's, a draw differs from JAX's by up to 2
    ulps (the program draws with the same emulation)."""
    lo = np.nextafter(np.float32(-1), np.float32(0))
    u = np.asarray(uniform(key, shape, lo, 1.0), np.float32)
    return (np.float32(np.sqrt(2)) * erf_inv(u))[()]
