"""Plain PyTorch version of the PSI tag PRF (``repro.kernels.psi_prf``).

A 5-round Feistel network over a 64-bit id held as two 32-bit lanes
(hi, lo), with a murmur3-fmix32 round function and fixed odd round
constants, after whitening the lanes with the row's session seed words.
``tag_hi`` is masked to 30 bits, so tags live in [0, 2^62) and the
sorted-intersect key ``(tag << 1) | origin`` stays below the padding
sentinels.

torch on the CPU has no uint32 add or shift, so the lanes ride in int64
with ``& 0xFFFFFFFF`` after every step, and the 32-bit multiplies split
the lane into 16-bit halves so that no int64 product overflows.
"""
from __future__ import annotations

import torch

ROUND_KEYS = (0x9E3779B9, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A, 0x510E527F)
TAG_HI_MASK = 0x3FFFFFFF          # 62-bit tags: room for the origin bit
_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for lanes x < 2^32 held in int64."""
    return (((((x >> 16) * c) & 0xFFFF) << 16) + (x & 0xFFFF) * c) & _M32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer: bijective multiply–xorshift mixer on u32."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def prf_tags(ids: torch.Tensor, seeds: torch.Tensor) -> torch.Tensor:
    """ids (R, N) int64, seeds (R, 2) int64 holding u32 words ->
    tags (R, N) int64 in [0, 2^62)."""
    hi = ((ids >> 32) & _M32) ^ seeds[:, 0:1]
    lo = (ids & _M32) ^ seeds[:, 1:2]
    for k in ROUND_KEYS:
        hi, lo = lo, hi ^ _fmix32((lo + k) & _M32)
    return ((hi & TAG_HI_MASK) << 32) | lo
