"""Zero-padding of ragged client slices into one batch (the layout part
of ``repro.kernels.padding``; the TPU's tile rounding, interpret switch
and VMEM budgets have no counterpart on the card)."""
from __future__ import annotations

from typing import Sequence

import torch


def stack_padded(mats: Sequence[torch.Tensor], rows: int, cols: int
                 ) -> torch.Tensor:
    """Zero-pad each (n_i, d_i) matrix to (rows, cols) and stack them
    into one (M, rows, cols) float32 batch.  Zero rows and columns are
    what the k-means pad-and-mask contract expects: zero columns add an
    exact +0.0 to every distance and centroid sum, zero rows are masked
    by ``n_valid``."""
    out = torch.zeros((len(mats), rows, cols), dtype=torch.float32,
                      device=mats[0].device)
    for i, m in enumerate(mats):
        out[i, :m.shape[0], :m.shape[1]] = m
    return out
