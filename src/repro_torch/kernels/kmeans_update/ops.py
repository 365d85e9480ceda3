"""Public fused Lloyd-step op: the CUDA kernels for CUDA tensors, the
plain PyTorch version for CPU tensors (or wherever ``impl="ref"``
asks)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.config import resolve_impl
from repro_torch.kernels.kmeans_update import ref
from repro_torch.kernels.kmeans_update.kernel import (
    kmeans_update_cuda, kmeans_update_gather_cuda)


def kmeans_update(points: torch.Tensor, centroids: torch.Tensor, *,
                  impl: Optional[str] = None,
                  idx: Optional[torch.Tensor] = None,
                  clients: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """points (M, N, d), centroids (M, K, d) f32 -> (assign (M, N) int32,
    sq_dist (M, N) f32, sums (M, K, d) f32, counts (M, K) f32), every
    row counted (the caller corrects zero-padded rows).

    With ``idx`` (M, B) int32 the step runs over the minibatch rows
    ``points[i, idx[i]]`` (K4 on CUDA, gathered inside the kernel):
    assign and sq_dist are (M, B), and sums and counts cover the B
    gathered rows, a duplicated index counted each time.

    ``clients`` (K3 only) is the client count the kernel cuts its CTAs
    for, ``M`` by default: a rank of a sharded fit passes the whole
    fit's, so each client's sums are added in the unsharded order.  The
    plain version's sums do not depend on the batch."""
    use_ref = resolve_impl(impl, points.device) == "ref"
    if idx is None:
        return (ref.kmeans_update(points, centroids) if use_ref
                else kmeans_update_cuda(points, centroids, clients))
    if use_ref:
        return ref.kmeans_update_gather(points, centroids, idx)
    return kmeans_update_gather_cuda(points, centroids, idx)
