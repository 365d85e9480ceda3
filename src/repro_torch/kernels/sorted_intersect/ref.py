"""Plain PyTorch version of the sorted-intersect step
(``repro.kernels.sorted_intersect``).

Key layout — one 63-bit integer per element, held as int64:

    key = (tag << 1) | origin        tag < 2^62,  origin: 0=sender 1=receiver

Inputs are two padded ascending key arrays per pair, A (receiver) and B
(sender), each (P,); each side pads its tail with its own sentinel,
``PAD_A`` / ``PAD_B`` (top bit set, so they sort after every real key;
as int64 they are -1 and -2).  Keys are unique within each side.

Outputs per pair over the merged (2P,) order: ``merged`` keys, ``rank``
= cumsum(origin) (the count of receiver keys so far, which indexes the
receiver's tag-sorted ids), and ``sel`` = a receiver slot whose
predecessor is the same tag from the sender with a valid (top bit
clear) key.  The ordering is unsigned: the sort runs on ``key ^
INT64_MIN`` as signed int64, which orders exactly as unsigned.
"""
from __future__ import annotations

from typing import Tuple

import torch

# per-side padding sentinels as (hi, lo) u32 lanes, and as int64 bits
PAD_A = (0xFFFFFFFF, 0xFFFFFFFF)      # receiver-side pad key
PAD_B = (0xFFFFFFFF, 0xFFFFFFFE)      # sender-side pad key
PAD_A64 = -1
PAD_B64 = -2
INT64_MIN = -(2 ** 63)


def sorted_intersect(a: torch.Tensor, b: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """a, b (pairs, P) int64 padded ascending keys -> (sel (pairs, 2P)
    int32, rank (pairs, 2P) int32, merged (pairs, 2P) int64)."""
    flipped = torch.cat([a, b], dim=1) ^ INT64_MIN
    merged = torch.sort(flipped, dim=1).values ^ INT64_MIN
    origin = merged & 1
    rank = torch.cumsum(origin, dim=1).to(torch.int32)
    # origin bit set ⇒ key - 1 == key ^ 1; the predecessor must be it
    prev_match = (merged[:, 1:] ^ 1) == merged[:, :-1]
    sel = torch.zeros_like(merged, dtype=torch.bool)
    sel[:, 1:] = prev_match
    sel &= (origin == 1) & (merged >= 0)
    return sel.to(torch.int32), rank, merged
