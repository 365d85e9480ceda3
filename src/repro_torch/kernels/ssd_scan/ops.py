"""Public SSD scan op: the CUDA kernel K12 for CUDA tensors, the plain
PyTorch version for CPU tensors (or wherever ``impl="ref"`` asks)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.config import resolve_impl
from repro_torch.kernels.ssd_scan import ref
from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int = 128,
             impl: Optional[str] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,H,P) f32, dt (B,S,H) f32 (softplus'ed), A (H,) negative,
    B/C (B,S,N) f32 -> (y (B,S,H,P), final_state (B,H,P,N))."""
    if resolve_impl(impl, x.device) == "ref":
        return ref.ssd_scan(x, dt, A, B, C, chunk)
    return ssd_scan_cuda(*(t.float().contiguous() for t in (x, dt, A, B, C)),
                         chunk=chunk)
