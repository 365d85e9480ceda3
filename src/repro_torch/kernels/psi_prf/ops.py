"""Public PSI tag PRF op: the CUDA kernel for CUDA tensors, the plain
PyTorch version for CPU tensors (or wherever ``impl="ref"`` asks)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config import resolve_impl
from repro_torch.kernels.psi_prf import ref
from repro_torch.kernels.psi_prf.kernel import prf_tags_cuda


def prf_tags(ids: torch.Tensor, seeds: torch.Tensor, *,
             impl: Optional[str] = None) -> torch.Tensor:
    """ids (R, N) int64, seeds (R, 2) int64 u32 words -> (R, N) int64
    62-bit tags.  ``impl=None`` picks by the tensors' device;
    ``impl="kernel"`` on a CPU tensor raises."""
    if resolve_impl(impl, ids.device) == "ref":
        return ref.prf_tags(ids, seeds)
    return prf_tags_cuda(ids, seeds)
