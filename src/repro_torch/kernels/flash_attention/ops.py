"""Public flash attention op: the CUDA kernel K11 for CUDA tensors, the
plain PyTorch version for CPU tensors (or wherever ``impl="ref"`` asks).

On the kernel route the op is differentiable: ``FlashAttention``, an
autograd ``Function``, launches K11 forward with its row log-sum-exp
and saves q, k, v, the output and the LSE; its backward launches K11's
backward kernel on them (under remat the recomputed forward saves its
own).  The plain route
differentiates through PyTorch's own ops.  Neither route falls back to
the other: a kernel that fails to build or launch raises."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config import resolve_impl
from repro_torch.kernels.flash_attention import ref
from repro_torch.kernels.flash_attention.kernel import (
    flash_attention_bwd_cuda, flash_attention_cuda)


class FlashAttention(torch.autograd.Function):
    """K11 forward and backward.  ``forward`` runs with grad mode off, as
    every ``Function``'s does, so the raw launch takes operands that
    require grad here."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, prefix: int,
                logit_cap: float):
        out, lse = flash_attention_cuda(q, k, v, causal=causal,
                                        window=window, prefix=prefix,
                                        logit_cap=logit_cap, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = dict(causal=causal, window=window, prefix=prefix,
                        logit_cap=logit_cap)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, out, do.contiguous(),
                                              lse, **ctx.mask)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, prefix: int = 0,
                    logit_cap: float = 0.0, impl: Optional[str] = None
                    ) -> torch.Tensor:
    """q (B,Sq,H,Dh), k/v (B,Sk,KV,Dh) -> (B,Sq,H,Dh) in q's dtype; query
    row r sits at position Sk - Sq + r (suffix alignment)."""
    if resolve_impl(impl, q.device) == "ref":
        return ref.flash_attention(q, k, v, causal=causal, window=window,
                                   prefix=prefix, logit_cap=logit_cap)
    return FlashAttention.apply(q.contiguous(), k.contiguous(),
                                v.contiguous(), bool(causal), int(window),
                                int(prefix), float(logit_cap))
