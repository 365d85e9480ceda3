"""Public k-means assign op: the CUDA kernel for CUDA tensors, the plain
PyTorch version for CPU tensors (or wherever ``impl="ref"`` asks)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.config import resolve_impl
from repro_torch.kernels.kmeans_assign import ref
from repro_torch.kernels.kmeans_assign.kernel import kmeans_assign_cuda


def kmeans_assign(points: torch.Tensor, centroids: torch.Tensor, *,
                  impl: Optional[str] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """points (M, N, d), centroids (M, K, d) f32 -> (assign (M, N) int32,
    sq_dist (M, N) f32)."""
    if resolve_impl(impl, points.device) == "ref":
        return ref.kmeans_assign(points, centroids)
    return kmeans_assign_cuda(points, centroids)
