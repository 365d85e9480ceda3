"""Wrapper of the CUDA k-means assign kernel (``csrc/kmeans_assign.cu``),
the port of ``repro/kernels/kmeans_assign/kernel.py::
kmeans_assign_pallas``."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build


def kmeans_assign_cuda(points: torch.Tensor, centroids: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """points (M, N, d), centroids (M, K, d) f32 on one CUDA device ->
    (assign (M, N) int32, sq_dist (M, N) f32)."""
    build.require_cuda("kmeans_assign", points, centroids,
                       dtype=torch.float32)
    m, n, d = points.shape
    k = centroids.shape[1]
    if centroids.shape != (m, k, d):
        raise ValueError(f"kmeans_assign: centroids {tuple(centroids.shape)}"
                         f" do not match points {tuple(points.shape)}")
    assign = torch.empty((m, n), dtype=torch.int32, device=points.device)
    sq_dist = torch.empty((m, n), dtype=torch.float32, device=points.device)
    fn = build.function("kmeans_assign", "kmeans_assign_launch", 4, 5)
    err = build.launch(fn, points.device,
                       points.data_ptr(), centroids.data_ptr(),
                       assign.data_ptr(), sq_dist.data_ptr(), m, n, k, k, d)
    build.check(err, "kmeans_assign")
    build.LAUNCHES["kmeans_assign"] += 1
    return assign, sq_dist
