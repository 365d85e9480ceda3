"""Published peaks of the cards the benchmark knows (NVIDIA's data
sheet, SXM part, dense, at the full 700 W power limit): float32 outside
the tensor cores, which the port's f32 path with TF32 off runs on, and
HBM bandwidth."""
from __future__ import annotations

from typing import Optional

PEAKS = {
    "H100": {"f32_flops": 67e12, "hbm_bytes_per_s": 3.35e12},
}


def peak(kind: str) -> Optional[dict]:
    """The peaks of the card named ``kind`` (``get_device_name``), or
    None for a card not in the table."""
    for mark, p in PEAKS.items():
        if mark in kind:
            return p
    return None
