"""Plain PyTorch versions of the block-diagonal SplitNN bottom layer
(``repro.kernels.splitnn_bottom.ref``), unpadded: one batched GEMM, then
the bias, then the ReLU, in the reference's order; and the int8 twin,
an exact integer accumulator under the reference's f32 epilogue."""
from __future__ import annotations

from typing import Optional

import torch


def splitnn_bottom(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   relu: bool, idx: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """x (M, B, d) — or the full (M, N, d) slab with ``idx`` (B,) — w
    (M, d, o), b (M, o) f32 -> (M, B, o) ``relu?(x[m] @ w[m] + b[m])``."""
    if idx is not None:
        x = x.index_select(1, idx)
    out = torch.bmm(x, w) + b[:, None, :]
    return torch.relu(out) if relu else out


def splitnn_bottom_int8(xq: torch.Tensor, sx: torch.Tensor,
                        wq: torch.Tensor, sw: torch.Tensor, b: torch.Tensor,
                        relu: bool, idx: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """xq (M, B, d) int8 — or the full (M, N, d) slab with ``idx`` (B,)
    — with per-row f32 scales sx (M, B) (already gathered with ``idx``),
    wq (M, d, o) int8 with per-column scales sw (M, o), b (M, o) f32 ->
    (M, B, o) f32 ``relu?(i32(xq[m] @ wq[m]) * (sx·sw) + b)``.

    The accumulator is a float64 ``bmm`` of the int8 values: every
    product and partial sum is an integer below 2^53 (|acc| <= d·127²),
    so it is exact in any summation order on any device, and equals the
    reference's i32 accumulator.  (``torch.bmm`` has no integer path on
    CUDA.)  The epilogue then rounds as the reference does: the scale
    product, ``acc * scale``, ``+ b``, each its own f32 operation."""
    if idx is not None:
        xq = xq.index_select(1, idx)
    acc = torch.bmm(xq.double(), wq.double()).to(torch.int32)
    out = acc.float() * (sx[:, :, None] * sw[:, None, :]) + b[:, None, :]
    return torch.relu(out) if relu else out
