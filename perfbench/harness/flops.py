"""Model FLOPs of the SplitNN, counted from shapes, for the MFU metrics.

A row's forward pass: each client's bottom, 2·d_m·o (+ o for the bias);
for the mlp the top, 2·(M·o)·H + H and 2·H·c + c.  Training a row costs
the forward, and for every layer whose weight trains the gradient of
the weight (as much as its forward product) and, above the bottom, the
gradient of its input (as much again): the bottom's input is data and
needs none.  Element-wise work (ReLU, loss, Adam) is not counted.
"""
from __future__ import annotations

from typing import Sequence


def _layers(model: str, dims: Sequence[int], o: int, hidden: int,
            n_out: int):
    """(bottom forward ops a row, top forward ops a row)."""
    bottom = sum(2 * d * o + o for d in dims)
    if model in ("lr", "linreg"):
        return bottom, 0
    m = len(dims)
    return bottom, 2 * m * o * hidden + hidden + 2 * hidden * n_out + n_out


def forward_flops(model: str, dims: Sequence[int], o: int, hidden: int,
                  n_out: int) -> int:
    """Forward FLOPs of one row."""
    bottom, top = _layers(model, dims, o, hidden, n_out)
    return bottom + top


def train_flops(model: str, dims: Sequence[int], o: int, hidden: int,
                n_out: int) -> int:
    """Forward and backward FLOPs of one training row."""
    bottom, top = _layers(model, dims, o, hidden, n_out)
    return 2 * bottom + 3 * top
