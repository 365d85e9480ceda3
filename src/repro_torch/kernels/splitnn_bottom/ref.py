"""Plain PyTorch versions of the block-diagonal SplitNN bottom layer
(``repro.kernels.splitnn_bottom.ref``), unpadded: one batched GEMM, then
the bias, then the ReLU, in the reference's order, and its fp8 wire
form, that pass followed by the wire rounding; the int8 twin, an exact
integer accumulator under the reference's f32 epilogue; and the int8
twin's wire form, the plain composition the int8 wire runs (the
weights' column quantizer, the int8 pass, the wire rounding)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.quant import (dequantize_row_blocks, pow2,
                               quantize_columns, quantize_row_blocks)


def splitnn_bottom(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   relu: bool, idx: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """x (M, B, d) — or the full (M, N, d) slab with ``idx`` (B,) — w
    (M, d, o), b (M, o) f32 -> (M, B, o) ``relu?(x[m] @ w[m] + b[m])``."""
    if idx is not None:
        x = x.index_select(1, idx)
    out = torch.bmm(x, w) + b[:, None, :]
    return torch.relu(out) if relu else out


def splitnn_bottom_fp8_wire(x: torch.Tensor, w: torch.Tensor,
                            b: torch.Tensor, relu: bool,
                            idx: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The f32 bottom pass as the fp8 wire runs it: ``pre =
    splitnn_bottom(x, w, b, relu, idx)`` and its wire rounding, ``quant.
    fake_quantize(pre, "fp8")``'s forward (pow2 exponents a block of
    ``QUANT_BLOCK_ROWS`` rows a client, e4m3 values) -> (wire, pre), each
    (M, B, o) f32.  fp8 is comm-only: the product stays f32."""
    pre = splitnn_bottom(x, w, b, relu, idx)
    return dequantize_row_blocks(*quantize_row_blocks(pre, "fp8")), pre


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


def splitnn_bottom_int8_wire(xq: torch.Tensor, sx: torch.Tensor,
                             w: torch.Tensor, b: torch.Tensor, relu: bool,
                             idx: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The int8 bottom pass as the quantized wire runs it: xq (M, N, d)
    int8 with its row scales sx (M, N) (``ops.int8_rows`` of x; the full
    slab with ``idx`` (B,), sx not yet gathered), w (M, d, o) f32
    quantized here by columns, b (M, o) f32 -> (wire, pre), each (M, B,
    o) f32: ``pre`` the int8 pass's output, ``wire`` its wire rounding,
    ``quant.fake_quantize(pre, "int8")``'s forward (pow2 exponents a
    block of ``QUANT_BLOCK_ROWS`` rows a client)."""
    wq, ew = quantize_columns(w, "int8")
    if idx is not None:      # row scales commute with the row gather
        sx = sx.index_select(1, idx)
    pre = splitnn_bottom_int8(xq, sx, wq, pow2(ew), b, relu, idx)
    return dequantize_row_blocks(*quantize_row_blocks(pre, "int8")), pre
