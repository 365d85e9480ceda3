"""Wrapper of the CUDA fused Lloyd step (``csrc/kmeans_update.cu``), the
port of ``repro/kernels/kmeans_update/kernel.py::kmeans_update_pallas``."""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build


def kmeans_update_cuda(points: torch.Tensor, centroids: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                  torch.Tensor]:
    """points (M, N, d), centroids (M, K, d) f32 on one CUDA device ->
    (assign (M, N) int32, sq_dist (M, N) f32, sums (M, K, d) f32,
    counts (M, K) f32).  Sums are reduced in a fixed block order, so two
    runs give the same bits."""
    build.require_cuda("kmeans_update", points, centroids,
                       dtype=torch.float32)
    m, n, d = points.shape
    k = centroids.shape[1]
    if centroids.shape != (m, k, d):
        raise ValueError(f"kmeans_update: centroids {tuple(centroids.shape)}"
                         f" do not match points {tuple(points.shape)}")
    blocks_fn = build.library("kmeans_update").kmeans_update_blocks
    blocks_fn.argtypes = [ctypes.c_longlong]
    blocks_fn.restype = ctypes.c_longlong
    dev = points.device
    assign = torch.empty((m, n), dtype=torch.int32, device=dev)
    sq_dist = torch.empty((m, n), dtype=torch.float32, device=dev)
    partials = torch.empty((m, blocks_fn(n), k * d + k), dtype=torch.float32,
                           device=dev)
    sums = torch.empty((m, k, d), dtype=torch.float32, device=dev)
    counts = torch.empty((m, k), dtype=torch.float32, device=dev)
    fn = build.function("kmeans_update", "kmeans_update_launch", 7, 5)
    with torch.cuda.device(dev):
        err = fn(points.data_ptr(), centroids.data_ptr(), assign.data_ptr(),
                 sq_dist.data_ptr(), partials.data_ptr(), sums.data_ptr(),
                 counts.data_ptr(), m, n, k, k,
                 d, torch.cuda.current_stream().cuda_stream)
    build.check(err, "kmeans_update")
    build.LAUNCHES["kmeans_update"] += 1
    return assign, sq_dist, sums, counts
