"""Plain PyTorch version of the k-means assign step
(``repro.kernels.kmeans_assign``), batched over M clients."""
from __future__ import annotations

from typing import Tuple

import torch


def kmeans_assign(points: torch.Tensor, centroids: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """points (M, N, d) f32, centroids (M, K, d) f32 -> (assign (M, N)
    int32, sq_dist (M, N) f32): d² = ‖p‖² − 2p·c + ‖c‖², clamped at 0,
    first-minimum argmin."""
    p = points.float()
    c = centroids.float()
    p2 = (p * p).sum(-1, keepdim=True)                    # (M, N, 1)
    c2 = (c * c).sum(-1).unsqueeze(1)                     # (M, 1, K)
    d = p2 - 2.0 * torch.bmm(p, c.transpose(1, 2)) + c2   # (M, N, K)
    d = d.clamp_min(0.0)
    sq_dist, assign = d.min(dim=-1)
    return assign.to(torch.int32), sq_dist
