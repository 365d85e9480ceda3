"""Plain PyTorch version of the fused k-means Lloyd update step
(``repro.kernels.kmeans_update``), batched over M clients: the assign
step, then per-cluster sums and counts with ``index_add_``."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.kmeans_assign import ref as assign_ref


def kmeans_update(points: torch.Tensor, centroids: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """points (M, N, d) f32, centroids (M, K, d) f32 -> (assign (M, N)
    int32, sq_dist (M, N) f32, sums (M, K, d) f32, counts (M, K) f32)."""
    m, n, d = points.shape
    k = centroids.shape[1]
    assign, sq_dist = assign_ref.kmeans_assign(points, centroids)
    seg = (torch.arange(m, device=points.device)[:, None] * k
           + assign).reshape(-1)
    sums = torch.zeros((m * k, d), dtype=torch.float32, device=points.device)
    sums.index_add_(0, seg, points.float().reshape(m * n, d))
    counts = torch.zeros(m * k, dtype=torch.float32, device=points.device)
    counts.index_add_(0, seg, torch.ones(m * n, dtype=torch.float32,
                                         device=points.device))
    return assign, sq_dist, sums.view(m, k, d), counts.view(m, k)
