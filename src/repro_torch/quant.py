"""Activation wire-dtype byte accounting: the part of ``repro.quant``
that the training and serving engines read (``resolve_quant``,
``wire_bytes``, ``scale_bytes_per_step``, ``payload_bytes``), copied
as it is so ``comm_bytes`` and ``gather_payload_bytes`` match the
reference exactly.

The quantizers themselves (pow2-exponent int8/fp8 rows and columns,
the quantized all-gather, the int8 bottom kernels) come with the quant
slice (ROADMAP.md, queue 4); until then ``require_f32`` makes every
engine refuse a non-``None`` ``quant``.
"""
from __future__ import annotations

from typing import Optional

__all__ = ["QUANT_BLOCK_ROWS", "resolve_quant", "require_f32", "wire_bytes",
           "scale_bytes_per_step", "payload_bytes"]

# Rows per shared-exponent block for the comm path (the reference's
# constant: 8 divides every local batch of its mesh matrix).
QUANT_BLOCK_ROWS = 8


def resolve_quant(quant: Optional[str]) -> Optional[str]:
    """Normalise a user-facing quant knob to None | 'int8' | 'fp8'."""
    if quant in (None, "", "none", "f32", "fp32"):
        return None
    if quant not in ("int8", "fp8"):
        raise ValueError(
            f"unknown quant={quant!r}: expected None, 'int8' or 'fp8'")
    return quant


def require_f32(quant: Optional[str]) -> None:
    """Raise for a quantized wire dtype: the port's engines move f32
    activations only until the quant slice lands."""
    if resolve_quant(quant) is not None:
        raise NotImplementedError(
            f"quant={quant!r}: quantized activations come with the quant "
            "slice of the port (ROADMAP.md, queue 4)")


def wire_bytes(quant: Optional[str]) -> int:
    """Bytes per communicated activation element (4 for f32)."""
    return 1 if quant else 4


def _row_blocks(b: int, block_rows: int) -> int:
    return -(-b // block_rows)


def scale_bytes_per_step(rows: int, m_clients: int,
                         quant: Optional[str]) -> int:
    """Exponent bytes added to one step's gathered payload (0 for f32)."""
    if not quant:
        return 0
    return _row_blocks(rows, QUANT_BLOCK_ROWS) * m_clients


def payload_bytes(width: int, rows: int, m_clients: int,
                  quant: Optional[str]) -> int:
    """Modeled forward activation payload of one step's client→server
    send: ``rows * width`` elements per client in the wire dtype, plus
    one exponent byte per row block per client when quantized, at the
    LOGICAL batch rows."""
    per_client = rows * width * wire_bytes(quant)
    if quant:
        per_client += _row_blocks(rows, QUANT_BLOCK_ROWS)
    return per_client * m_clients
