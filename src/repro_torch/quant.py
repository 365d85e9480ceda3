"""Quantized activation wire (int8/fp8): the port of ``repro.quant``.

Each client's bottom activations may travel to the label owner in a
1-byte wire dtype instead of f32 (DESIGN.md §12):

* **Scales are powers of two**, one int8 *exponent* per
  ``QUANT_BLOCK_ROWS``-row block per client (per row or per column for
  the int8 GEMM's operands).  Scales are built from the exponent's bits
  (``pow2``), so they are exact powers of two on every device and
  dequantizing adds no rounding beyond the cast itself.
* **Exact zeros are kept**: an all-zero block gets exponent 0 and
  quantizes to 0, so zero-padded rows and dummy clients stay zero.
* **Subnormals flush to zero, as in the reference.**  The reference
  computes ``amax / qmax`` under XLA, which flushes subnormal results on
  both of its platforms (CPU and TPU); a block whose ``amax / qmax`` is
  below ``torch.finfo(torch.float32).tiny`` therefore gets exponent 0
  and quantizes to exact zero.  ``pow2_exponent`` applies that rule,
  and ``dequantize`` flushes a subnormal product the same way.
* **The backward is straight-through**: ``fake_quantize`` rounds in the
  forward and passes the gradient through unchanged.

The byte accounting (``wire_bytes``, ``scale_bytes_per_step``,
``payload_bytes``) is the reference's, copied as it is so
``comm_bytes`` and ``gather_payload_bytes`` match exactly.
``all_gather_quantized`` is the wire of a mesh whose clients shard over
a ``model`` dim: each rank's wire values and exponents travel as ONE
int8 payload in one all-gather (``repro_torch.sharding``), its backward
the f32 reduce-scatter (the STE).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.sharding import (MeshAxis, all_gather_rows,
                                  reduce_scatter_rows)

__all__ = [
    "FP8_DTYPE",
    "QUANT_BLOCK_ROWS",
    "all_gather_quantized",
    "dequantize",
    "dequantize_row_blocks",
    "fake_quantize",
    "pack_payload",
    "payload_bytes",
    "pow2",
    "pow2_exponent",
    "quantize_columns",
    "quantize_row_blocks",
    "quantize_rows",
    "resolve_quant",
    "scale_bytes_per_step",
    "supported_quants",
    "unpack_payload",
    "wire_bytes",
]

# Rows per shared-exponent block for the comm path (the reference's
# constant: 8 divides every local batch of its mesh matrix).
QUANT_BLOCK_ROWS = 8

# Largest representable magnitude per wire dtype (int8 symmetric range;
# float8_e4m3fn finite max).
_QMAX = {"int8": 127.0, "fp8": 448.0}

FP8_DTYPE = torch.float8_e4m3fn

_TINY = torch.finfo(torch.float32).tiny


def supported_quants() -> Tuple[str, ...]:
    """Wire dtypes this build can produce (torch has float8_e4m3fn)."""
    return ("int8", "fp8")


def resolve_quant(quant: Optional[str]) -> Optional[str]:
    """Normalise a user-facing quant knob to None | 'int8' | 'fp8'."""
    if quant in (None, "", "none", "f32", "fp32"):
        return None
    if quant not in ("int8", "fp8"):
        raise ValueError(
            f"unknown quant={quant!r}: expected None, 'int8' or 'fp8'")
    return quant


def wire_bytes(quant: Optional[str]) -> int:
    """Bytes per communicated activation element (4 for f32)."""
    return 1 if quant else 4


def pow2_exponent(amax: torch.Tensor, quant: str) -> torch.Tensor:
    """Smallest int8 exponent e with ``amax <= qmax * 2**e``.

    ``frexp`` gives amax/qmax = mant * 2**expo with mant in [0.5, 1), so
    ``expo - (mant == 0.5)`` is exactly ceil(log2(amax/qmax)).  amax/qmax
    == 0 or below the smallest normal f32 maps to e = 0 (the reference's
    flush to zero: such blocks quantize to exact zero).  So e lies in
    [-126, 122] for every finite amax, and every scale ``2**e`` is a
    normal f32.  The quotient divides by a tensor: CUDA divides by a
    host scalar as a multiply by its reciprocal, which rounds amax/qmax
    across a power of two for some amax (3.0279161e-05 / 127), and the
    exponent with it.
    """
    r = amax / torch.full_like(amax, _QMAX[quant])
    mant, expo = torch.frexp(r)
    e = expo - (mant == 0.5).to(expo.dtype)
    e = torch.where(r >= _TINY, e, torch.zeros_like(e))
    return e.clamp(-127, 127).to(torch.int8)


def pow2(e: torch.Tensor) -> torch.Tensor:
    """``2**e`` in f32, built from the exponent bits: exact for e in
    [-126, 127] on every device (``exp2`` promises no such thing)."""
    return ((e.to(torch.int32) + 127) << 23).view(torch.float32)


def _encode(x: torch.Tensor, e: torch.Tensor, quant: str) -> torch.Tensor:
    """Quantize f32 ``x`` against broadcastable int8 exponents ``e``."""
    v = x * pow2(-e.to(torch.int32))
    if quant == "int8":
        return torch.clamp(torch.round(v), -127.0, 127.0).to(torch.int8)
    return torch.clamp(v, -_QMAX["fp8"], _QMAX["fp8"]).to(FP8_DTYPE)


def dequantize(q: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """Wire values * 2**e, in f32 (broadcastable exponents); a subnormal
    product (an fp8 subnormal under e < -117) flushes to a signed zero,
    as the reference's does."""
    x = q.float() * pow2(e)
    return torch.where(x.abs() < _TINY, x * 0.0, x)


def quantize_rows(x: torch.Tensor, quant: str
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row (last axis reduced) symmetric quantization:
    ``(..., d) f32 -> (q (..., d) wire, e (...) int8)``."""
    e = pow2_exponent(x.abs().amax(-1), quant)
    return _encode(x, e[..., None], quant), e


def quantize_columns(w: torch.Tensor, quant: str
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-column quantization of packed weights:
    ``(M, d, o) f32 -> (q (M, d, o) wire, e (M, o) int8)``."""
    e = pow2_exponent(w.abs().amax(1), quant)
    return _encode(w, e[:, None, :], quant), e


def _row_blocks(b: int, block_rows: int) -> int:
    return -(-b // block_rows)


def _blocked(t: torch.Tensor, block_rows: int) -> torch.Tensor:
    """(M, B, o) -> (M, nb, block_rows * o), the ragged tail block padded
    with zeros inside the block."""
    m, b, o = t.shape
    nb = _row_blocks(b, block_rows)
    pad = nb * block_rows - b
    if pad:
        t = torch.cat([t, t.new_zeros((m, pad, o))], 1)
    return t.reshape(m, nb, block_rows * o)


def quantize_row_blocks(acts: torch.Tensor, quant: str,
                        block_rows: int = QUANT_BLOCK_ROWS
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-client, per-row-block quantization of activations:
    ``(M, B, o) f32 -> (q (M, B, o) wire, e (M, nb) int8)`` with
    ``nb = ceil(B / block_rows)`` (zero padding inside the tail block
    never changes its amax)."""
    m, b, o = acts.shape
    blocks = _blocked(acts, block_rows)
    e = pow2_exponent(blocks.abs().amax(-1), quant)
    q = _encode(blocks, e[..., None], quant)
    return q.reshape(m, -1, o)[:, :b], e


def dequantize_row_blocks(q: torch.Tensor, e: torch.Tensor,
                          block_rows: int = QUANT_BLOCK_ROWS
                          ) -> torch.Tensor:
    """Inverse of ``quantize_row_blocks`` (up to wire rounding)."""
    m, b, o = q.shape
    x = dequantize(_blocked(q, block_rows), e[..., None])
    return x.reshape(m, -1, o)[:, :b]


def pack_payload(q: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """Wire values + exponent bytes as ONE int8 array:
    ``(q (M, B, o), e (M, nb)) -> (M, B*o + nb) int8``; fp8 rides as its
    int8 bit pattern (same itemsize, bit-exact)."""
    m, b, o = q.shape
    if q.dtype != torch.int8:
        q = q.view(torch.int8)
    return torch.cat([q.reshape(m, b * o), e], 1)


def unpack_payload(payload: torch.Tensor, b: int, o: int, quant: str
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split a packed payload back into (q, e)."""
    m = payload.shape[0]
    q = payload[:, :b * o].reshape(m, b, o)
    if quant == "fp8":
        q = q.view(FP8_DTYPE)
    return q, payload[:, b * o:]


class _FakeQuantize(torch.autograd.Function):
    @staticmethod
    def forward(ctx, acts, quant):
        return dequantize_row_blocks(*quantize_row_blocks(acts, quant))

    @staticmethod
    def backward(ctx, g):
        return g, None


def fake_quantize(acts: torch.Tensor, quant: str) -> torch.Tensor:
    """Quantize -> dequantize with an identity backward (the STE): the
    wire rounding a quantized send applies, on one device."""
    return _FakeQuantize.apply(acts, quant)


class _AllGatherQuantized(torch.autograd.Function):
    @staticmethod
    def forward(ctx, acts, axis, quant):
        ctx.axis = axis
        _, b, o = acts.shape
        payload = all_gather_rows(
            pack_payload(*quantize_row_blocks(acts, quant)), axis)
        return dequantize_row_blocks(*unpack_payload(payload, b, o, quant))

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_rows(g, ctx.axis), None, None


def all_gather_quantized(acts: torch.Tensor, axis: MeshAxis,
                         quant: str) -> torch.Tensor:
    """The quantized all-gather of the clients' activations over a mesh
    dim: this rank's (M_loc, B, o) f32 block quantized by row blocks,
    packed with its exponents into ONE int8 payload, one tiled
    all-gather, then unpacked and dequantized -> (size·M_loc, B, o) f32,
    the f32 gather's shape.  The backward is straight-through: the f32
    sum reduce-scatter, the f32 gather's transpose.  A block the wire
    already rounded (the bottom pass's wire forms) quantizes to the same
    values again, so the fused kernels' rounding is what arrives."""
    return _AllGatherQuantized.apply(acts, axis, quant)


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
