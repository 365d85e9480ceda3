"""Public fused Lloyd-step op: the CUDA kernel for CUDA tensors, the
plain PyTorch version for CPU tensors (or wherever ``impl="ref"``
asks)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.config import resolve_impl
from repro_torch.kernels.kmeans_update import ref
from repro_torch.kernels.kmeans_update.kernel import kmeans_update_cuda


def kmeans_update(points: torch.Tensor, centroids: torch.Tensor, *,
                  impl: Optional[str] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """points (M, N, d), centroids (M, K, d) f32 -> (assign (M, N) int32,
    sq_dist (M, N) f32, sums (M, K, d) f32, counts (M, K) f32), every
    row counted (the caller corrects zero-padded rows)."""
    if resolve_impl(impl, points.device) == "ref":
        return ref.kmeans_update(points, centroids)
    return kmeans_update_cuda(points, centroids)
