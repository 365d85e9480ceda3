"""Differentiable public op of the block-diagonal SplitNN bottom layer
(the port of ``repro.kernels.splitnn_bottom.ops``).

``splitnn_bottom(x, w, b, relu, impl, idx=None, quant=None, x_int8=None)``
runs the CUDA kernel (``impl="kernel"``: K1, or K2 with ``idx``; under
``quant="fp8"`` their fp8 wire form, under ``quant="int8"`` their int8
twins K9 and K10) or the plain PyTorch version (``impl="ref"``);
``None`` picks the kernel for CUDA tensors and the plain version for CPU
tensors.  There is no fallback: the kernel on a CPU tensor raises.

``quant="int8"`` is the int8 activation wire: x quantized by rows and w
by columns (pow2 scales, ``repro_torch.quant``), the i8×i8→i32 GEMM with
the f32 scale and bias epilogue, then the wire rounding of the
activation send, ``quant.fake_quantize(·, "int8")``; the op returns the
wire value.  The reference runs the same three steps, its
``_int8_operands``, int8 ``splitnn_bottom`` and ``fake_quantize``
(``repro/train/vfl.py:228,267``).  On CUDA that is ONE launch of K9/K10's
wire form, which quantizes w, and K9's rows, in its operand loads and
rounds in its epilogue; with ``idx`` it takes the slab's int8 rows and
row scales (``x_int8``, else ``int8_rows(x)``) and gathers both.  On the
CPU it is the plain composition ``ref.splitnn_bottom_int8_wire``.
``quant="fp8"`` is comm-only: the GEMM stays f32 (as the reference's,
``repro/kernels/splitnn_bottom/ops.py:93-96``), then the wire rounding
of the activation send, ``quant.fake_quantize(·, "fp8")``; the op
returns the wire value.  On CUDA that is ONE launch of K1/K2's fp8 wire
form, whose pass is bitwise the f32 form's and whose epilogue rounds; on
the CPU the plain composition ``ref.splitnn_bottom_fp8_wire``.  The
reference pads before it quantizes; the port works on unpadded operands,
which quantize each real element identically (zero padding never
changes a row or column amax).

A ``torch.autograd.Function`` routes every impl and quant through ONE
backward, the reference's f32 straight-through pass (``ops.py:155-179``),
so their gradients cannot diverge:

  dpre = g ⊙ 1[pre > 0]      (ReLU mask of the forward that ran, quantized
                              or not, read BEFORE the wire rounding, as
                              the reference's mask precedes its
                              fake_quantize; pre > 0 ⟺ pre-activation > 0)
  dw   = xgᵀ @ dpre          db = Σ_B dpre
  dx   = dpre @ wᵀ           (only when x needs a gradient; with idx it
                              scatter-adds back into the slab rows)

as batched ``torch.bmm``s on the f32 ``x`` and ``w``: the reference
computes them outside any Pallas kernel, so the backward adds no kernel.
The wire rounding's own backward is the identity (the STE), so an
activation the wire rounds to 0 keeps its gradient.  The wire kernels
write ``pre`` only where that mask is needed (ReLU, and an operand that
requires grad under grad mode).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.config import resolve_impl
from repro_torch.kernels.splitnn_bottom import ref
from repro_torch.kernels.splitnn_bottom.kernel import (
    splitnn_bottom_cuda, splitnn_bottom_fp8_cuda,
    splitnn_bottom_fp8_gather_cuda, splitnn_bottom_gather_cuda,
    splitnn_bottom_int8_wire_cuda, splitnn_bottom_int8_wire_gather_cuda)
from repro_torch.quant import pow2, quantize_rows

__all__ = ["splitnn_bottom", "int8_rows"]


def int8_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (M, N, d) f32 -> (xq (M, N, d) int8, sx (M, N) f32): the int8
    operand of the quantized bottom pass with its exact pow2 row scales.
    A caller whose slab is loop-invariant computes this once and passes
    it as ``x_int8``."""
    xq, ex = quantize_rows(x, "int8")
    return xq, pow2(ex)


def _forward(x, w, b, relu: bool, impl: str, idx, quant, x_int8,
             keep_pre: bool):
    """(out, pre): ``pre`` is the output before the wire rounding (``out``
    itself without one; None where the kernel was told to skip it)."""
    if quant is None:
        if impl == "ref":
            out = ref.splitnn_bottom(x, w, b, relu, idx)
        elif idx is None:
            out = splitnn_bottom_cuda(x, w, b, relu)
        else:
            out = splitnn_bottom_gather_cuda(idx, x, w, b, relu)
        return out, out
    if quant == "fp8":
        if impl == "ref":
            return ref.splitnn_bottom_fp8_wire(x, w, b, relu, idx)
        if idx is None:
            return splitnn_bottom_fp8_cuda(x, w, b, relu, keep_pre)
        return splitnn_bottom_fp8_gather_cuda(idx, x, w, b, relu, keep_pre)
    if impl == "kernel" and idx is None:     # K9 quantizes the rows itself
        return splitnn_bottom_int8_wire_cuda(x, w, b, relu, keep_pre)
    xq, sx = int8_rows(x) if x_int8 is None else x_int8
    if impl == "ref":
        return ref.splitnn_bottom_int8_wire(xq, sx, w, b, relu, idx)
    return splitnn_bottom_int8_wire_gather_cuda(idx, xq, sx, w, b, relu,
                                                keep_pre)


class _SplitNNBottom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, relu, impl, idx, quant, x_int8, keep_pre):
        out, pre = _forward(x, w, b, relu, impl, idx, quant, x_int8,
                            keep_pre)
        ctx.save_for_backward(x, w, pre, idx)
        ctx.relu = relu
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, pre, idx = ctx.saved_tensors
        dpre = g * (pre > 0) if ctx.relu else g                 # (M, B, o)
        dx = dw = db = None
        if ctx.needs_input_grad[1]:
            xg = x if idx is None else x.index_select(1, idx)   # (M, B, d)
            dw = torch.bmm(xg.transpose(1, 2), dpre)             # (M, d, o)
        if ctx.needs_input_grad[2]:
            db = dpre.sum(1)                                     # (M, o)
        if ctx.needs_input_grad[0]:
            dx = torch.bmm(dpre, w.transpose(1, 2))              # (M, B, d)
            if idx is not None:     # duplicate schedule slots accumulate
                dx = torch.zeros_like(x).index_add_(1, idx, dx)
        return dx, dw, db, None, None, None, None, None, None


def splitnn_bottom(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   relu: bool = True, impl: Optional[str] = None,
                   idx: Optional[torch.Tensor] = None,
                   quant: Optional[str] = None,
                   x_int8: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                   ) -> torch.Tensor:
    """x (M, B, d), w (M, d, o), b (M, o) f32 -> (M, B, o) f32: every
    client's ``relu?(x[m] @ w[m] + b[m])`` in one pass.  With ``idx``
    (B,) int32, ``x`` is the full (M, N, d) slab and the minibatch
    gather ``x[:, idx]`` fuses into the pass (K2, or K10), bitwise-equal
    to gathering first.  ``quant`` is None, ``"int8"`` (the int8 GEMM and
    the wire rounding, K9/K10) or ``"fp8"`` (comm-only: the f32 GEMM and
    the wire rounding, K1/K2's fp8 wire form); under int8, ``x_int8`` may
    hold ``int8_rows(x)`` precomputed."""
    if quant not in (None, "int8", "fp8"):
        raise ValueError(f"splitnn_bottom: unknown quant={quant!r}")
    if quant == "int8" and x_int8 is not None and x_int8[0].shape != x.shape:
        raise ValueError(f"splitnn_bottom: x_int8 rows "
                         f"{tuple(x_int8[0].shape)} are not x's "
                         f"{tuple(x.shape)}")
    impl = resolve_impl(impl, x.device)
    keep_pre = bool(relu) and torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, w, b))
    return _SplitNNBottom.apply(x, w, b, bool(relu), impl, idx, quant,
                                x_int8, keep_pre)
