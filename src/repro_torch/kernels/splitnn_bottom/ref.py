"""Plain PyTorch version of the block-diagonal SplitNN bottom layer
(``repro.kernels.splitnn_bottom.ref``), unpadded: one batched GEMM, then
the bias, then the ReLU, in the reference's order."""
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
