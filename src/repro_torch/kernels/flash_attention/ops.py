"""Public flash attention op: the CUDA kernel K11 for CUDA tensors, the
plain PyTorch version for CPU tensors (or wherever ``impl="ref"`` asks)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config import resolve_impl
from repro_torch.kernels.flash_attention import ref
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, prefix: int = 0,
                    logit_cap: float = 0.0, impl: Optional[str] = None
                    ) -> torch.Tensor:
    """q (B,Sq,H,Dh), k/v (B,Sk,KV,Dh) -> (B,Sq,H,Dh) in q's dtype; query
    row r sits at position Sk - Sq + r (suffix alignment)."""
    if resolve_impl(impl, q.device) == "ref":
        return ref.flash_attention(q, k, v, causal=causal, window=window,
                                   prefix=prefix, logit_cap=logit_cap)
    return flash_attention_cuda(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal=causal, window=window,
                                prefix=prefix, logit_cap=logit_cap)
