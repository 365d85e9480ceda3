"""Differentiable public op of the block-diagonal SplitNN bottom layer
(the port of ``repro.kernels.splitnn_bottom.ops``, f32 only).

``splitnn_bottom(x, w, b, relu, impl, idx=None)`` runs the CUDA kernel
(``impl="kernel"``: K1, or K2 with ``idx``) or the plain PyTorch version
(``impl="ref"``); ``None`` picks the kernel for CUDA tensors and the
plain version for CPU tensors.  There is no fallback: the kernel on a CPU
tensor raises.

A ``torch.autograd.Function`` routes both impls through ONE backward, the
reference's (``ops.py:155-179``), so their gradients cannot diverge:

  dpre = g ⊙ 1[out > 0]      (ReLU mask; out > 0 ⟺ pre-activation > 0)
  dw   = xgᵀ @ dpre          db = Σ_B dpre
  dx   = dpre @ wᵀ           (only when x needs a gradient; with idx it
                              scatter-adds back into the slab rows)

as batched ``torch.bmm``s: the reference computes them outside any
Pallas kernel, so the backward adds no kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config import resolve_impl
from repro_torch.kernels.splitnn_bottom import ref
from repro_torch.kernels.splitnn_bottom.kernel import (
    splitnn_bottom_cuda, splitnn_bottom_gather_cuda)

__all__ = ["splitnn_bottom"]


def _forward(x, w, b, relu: bool, impl: str, idx):
    if impl == "ref":
        return ref.splitnn_bottom(x, w, b, relu, idx)
    if idx is None:
        return splitnn_bottom_cuda(x, w, b, relu)
    return splitnn_bottom_gather_cuda(idx, x, w, b, relu)


class _SplitNNBottom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, relu, impl, idx):
        out = _forward(x, w, b, relu, impl, idx)
        ctx.save_for_backward(x, w, out, idx)
        ctx.relu = relu
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, out, idx = ctx.saved_tensors
        dpre = g * (out > 0) if ctx.relu else g                 # (M, B, o)
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
        return dx, dw, db, None, None, None


def splitnn_bottom(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   relu: bool = True, impl: Optional[str] = None,
                   idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (M, B, d), w (M, d, o), b (M, o) f32 -> (M, B, o) f32: every
    client's ``relu?(x[m] @ w[m] + b[m])`` in one pass.  With ``idx``
    (B,) int32, ``x`` is the full (M, N, d) slab and the minibatch
    gather ``x[:, idx]`` fuses into the pass (K2), bitwise-equal to
    gathering first."""
    impl = resolve_impl(impl, x.device)
    return _SplitNNBottom.apply(x, w, b, bool(relu), impl, idx)
