"""Host-side threefry2x32: the ``jax.random`` draws on the port's path.

A numpy implementation of JAX's default PRNG (threefry2x32 with the
partitionable key layout, ``jax_threefry_partitionable=True``), written
from the algorithm, so that the port draws the same numbers as the
reference from the same seeds.  Keys are ``np.ndarray`` uint32 ``(2,)``.

Why on the host: the key stream of k-means++ does not depend on the
data, so every draw is computed here in numpy uint32 arithmetic (which
wraps as the algorithm needs; torch on the CPU has no uint32 add or
shift) and only the data-dependent ``cumsum``/``searchsorted`` of
``choice(p=)`` runs on the device (``repro_torch.core.kmeans``).

Parity with ``jax.random``: ``PRNGKey``, ``split``, ``randint`` and
``uniform`` are bitwise equal.  ``choice_index`` returns the same index
as ``jax.random.choice(key, n, p=p)`` whenever the draw does not land
within a few ulps of a boundary of ``cumsum(p)``: the reference computes
that cumsum as an associative scan on its device, the port as a
sequential or device scan, and the two can differ by ulps.
"""
from __future__ import annotations

import numpy as np

__all__ = ["PRNGKey", "split", "random_bits", "randint", "uniform",
           "choice_index"]

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


def random_bits(key: np.ndarray) -> np.uint32:
    """32 random bits for a scalar draw (counter (0, 0), lanes xored)."""
    b0, b1 = threefry2x32(key, np.zeros((), _u32), np.zeros((), _u32))
    return _u32(b0 ^ b1)


def randint(key: np.ndarray, minval: int, maxval: int) -> int:
    """Scalar ``jax.random.randint(key, (), minval, maxval)`` (int32).
    ``maxval`` may be a traced-style value such as a client's valid row
    count; the arithmetic is the reference's, wrapping uint32 products
    included."""
    k1, k2 = split(key)
    hi, lo = random_bits(k1), random_bits(k2)
    span = _u32(1) if maxval <= minval else _u32(maxval - minval)
    with np.errstate(over="ignore"):
        mult = _u32(2 ** 16) % span
        mult = (mult * mult) % span
        off = ((hi % span) * mult + (lo % span)) % span
    return int(minval) + int(off)


def uniform(key: np.ndarray) -> np.float32:
    """Scalar ``jax.random.uniform(key)`` in [0, 1) as float32: the top
    23 bits become the mantissa of a float in [1, 2), minus 1."""
    bits = (random_bits(key) >> _u32(9)) | _u32(0x3F800000)
    return np.float32(np.array(bits, _u32).view(np.float32) - np.float32(1))


def choice_index(key: np.ndarray, p: np.ndarray) -> int:
    """Scalar ``jax.random.choice(key, len(p), p=p)`` (with
    replacement): the first index whose ``cumsum(p)`` reaches
    ``cumsum(p)[-1] * (1 - u)``.  See the module docstring for the ulp
    caveat of the cumsum."""
    cum = np.cumsum(np.asarray(p, np.float32), dtype=np.float32)
    r = cum[-1] * (np.float32(1) - uniform(key))
    return int(np.searchsorted(cum, r, side="left"))
