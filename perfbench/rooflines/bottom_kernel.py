"""Bytes and operations of the SplitNN bottom kernel
(``bottom_kernel`` in ``kernels/csrc/splitnn_bottom.cu``): K1, one
block-diagonal pass ``relu?(x[m] @ w[m] + b[m])`` over a slab of rows,
and K2, the same over rows it gathers from the full slab by an index
list.  Both are one symbol.

Counted from the launch's shapes, as the roofline wants them: every
input byte read once and every output byte written once, whatever the
kernel reads again.  Inputs: the (M, B, d) rows (gathered ones for K2,
with the B int32 indices), w (M, d, o) and b (M, o), f32; output (M, B,
o) f32.  Operations: one multiply and one add a term of every product,
and the bias add, 2·M·B·d·o + M·B·o; the ReLU is a comparison and is
not counted.  ``d`` is the slab's width, the widest client's, which the
kernel reads for every client.
"""
from __future__ import annotations

SYMBOL = "bottom_kernel"
F32 = 4


def launch(m: int, rows: int, d: int, o: int, gather: bool):
    """(bytes, operations) of one launch over ``rows`` rows."""
    nbytes = F32 * (m * rows * d + m * d * o + m * o + m * rows * o)
    if gather:
        nbytes += 4 * rows
    ops = 2 * m * rows * d * o + m * rows * o
    return nbytes, ops


def bound_seconds(m: int, rows: int, d: int, o: int, gather: bool,
                  peak: dict) -> float:
    """The least time one launch can take on a card of ``peak``: the
    larger of its bytes at the HBM bandwidth and its operations at the
    f32 rate."""
    nbytes, ops = launch(m, rows, d, o, gather)
    return max(nbytes / peak["hbm_bytes_per_s"], ops / peak["f32_flops"])
