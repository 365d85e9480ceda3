"""Public sorted-intersect op plus the key packing it sorts on.

``pack_keys`` folds a 62-bit tag and the origin bit into one int64 key
(layout in ref.py); ``next_pow2`` is the reference's pad length rule.
Recovering plaintext ids from (sel, rank) is the engine's job.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.config import resolve_impl
from repro_torch.kernels.sorted_intersect import ref
from repro_torch.kernels.sorted_intersect.kernel import sorted_intersect_cuda
from repro_torch.kernels.sorted_intersect.ref import (PAD_A, PAD_A64, PAD_B,
                                                      PAD_B64)

__all__ = ["next_pow2", "pack_keys", "sorted_intersect", "PAD_A", "PAD_B",
           "PAD_A64", "PAD_B64"]


def next_pow2(n: int, floor: int = 8) -> int:
    return max(1 << (max(n, 1) - 1).bit_length(), floor)


def pack_keys(tags: torch.Tensor, origin: int) -> torch.Tensor:
    """62-bit tags (int64) + origin bit -> keys (tag << 1) | origin."""
    return (tags << 1) | origin


def sorted_intersect(a: torch.Tensor, b: torch.Tensor, *,
                     impl: Optional[str] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Receiver keys ``a`` / sender keys ``b``, (pairs, P) int64 each,
    ascending as unsigned and padded with PAD_A64 / PAD_B64 ->
    (sel, rank, merged) over the (pairs, 2P) merged order.
    ``impl=None`` picks by the tensors' device; ``impl="kernel"`` on a
    CPU tensor raises."""
    if resolve_impl(impl, a.device) == "ref":
        return ref.sorted_intersect(a, b)
    return sorted_intersect_cuda(a, b)
