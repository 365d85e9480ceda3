"""Wrappers of the CUDA fused Lloyd step (``csrc/kmeans_update.cu``): K3
``kmeans_update_cuda``, the port of ``repro/kernels/kmeans_update/
kernel.py::kmeans_update_pallas``, and K4 ``kmeans_update_gather_cuda``,
the port of ``::kmeans_update_gather_pallas``."""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build


def _outputs(name: str, points: torch.Tensor, centroids: torch.Tensor,
             rows: int):
    """Check the operands and allocate the outputs of a step over
    ``rows`` rows a client (and the per-block partials scratch)."""
    build.require_cuda(name, points, centroids, dtype=torch.float32)
    m, n, d = points.shape
    k = centroids.shape[1]
    if centroids.shape != (m, k, d):
        raise ValueError(f"{name}: centroids {tuple(centroids.shape)}"
                         f" do not match points {tuple(points.shape)}")
    blocks_fn = build.library("kmeans_update").kmeans_update_blocks
    blocks_fn.argtypes = [ctypes.c_longlong]
    blocks_fn.restype = ctypes.c_longlong
    dev = points.device
    return (m, n, d, k,
            torch.empty((m, rows), dtype=torch.int32, device=dev),
            torch.empty((m, rows), dtype=torch.float32, device=dev),
            torch.empty((m, blocks_fn(rows), k * d + k), dtype=torch.float32,
                        device=dev),
            torch.empty((m, k, d), dtype=torch.float32, device=dev),
            torch.empty((m, k), dtype=torch.float32, device=dev))


def kmeans_update_cuda(points: torch.Tensor, centroids: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                  torch.Tensor]:
    """K3: points (M, N, d), centroids (M, K, d) f32 on one CUDA device ->
    (assign (M, N) int32, sq_dist (M, N) f32, sums (M, K, d) f32,
    counts (M, K) f32).  Sums are reduced in a fixed block order, so two
    runs give the same bits."""
    m, n, d, k, assign, sq_dist, partials, sums, counts = _outputs(
        "kmeans_update", points, centroids, points.shape[1])
    fn = build.function("kmeans_update", "kmeans_update_launch", 7, 5)
    with torch.cuda.device(points.device):
        err = fn(points.data_ptr(), centroids.data_ptr(), assign.data_ptr(),
                 sq_dist.data_ptr(), partials.data_ptr(), sums.data_ptr(),
                 counts.data_ptr(), m, n, k, k,
                 d, torch.cuda.current_stream().cuda_stream)
    build.check(err, "kmeans_update")
    build.LAUNCHES["kmeans_update"] += 1
    return assign, sq_dist, sums, counts


def kmeans_update_gather_cuda(points: torch.Tensor, centroids: torch.Tensor,
                              idx: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor, torch.Tensor]:
    """K4: K3 over the rows ``points[i, idx[i]]``, gathered inside the
    kernel.  idx (M, B) int32, points (M, N, d), centroids (M, K, d) f32
    on one CUDA device -> (assign (M, B) int32, sq_dist (M, B) f32,
    sums (M, K, d), counts (M, K) f32 over the gathered rows, a
    duplicated index counted each time).  Bitwise K3 on the pre-gathered
    rows.  An index outside [0, N) gets assign -1 and sq_dist NaN and
    counts for no cluster."""
    if idx.dtype != torch.int32 or idx.dim() != 2 or (
            idx.shape[0] != points.shape[0]):
        raise ValueError("kmeans_update_gather: idx must be (M, B) int32, "
                         f"got {idx.dtype}{list(idx.shape)} for points "
                         f"{tuple(points.shape)}")
    build.require_cuda("kmeans_update_gather", idx, points)
    m, n, d, k, assign, sq_dist, partials, sums, counts = _outputs(
        "kmeans_update_gather", points, centroids, idx.shape[1])
    fn = build.function("kmeans_update", "kmeans_update_gather_launch", 8, 6)
    with torch.cuda.device(points.device):
        err = fn(idx.data_ptr(), points.data_ptr(), centroids.data_ptr(),
                 assign.data_ptr(), sq_dist.data_ptr(), partials.data_ptr(),
                 sums.data_ptr(), counts.data_ptr(), m, n, idx.shape[1], k, k,
                 d, torch.cuda.current_stream().cuda_stream)
    build.check(err, "kmeans_update_gather")
    build.LAUNCHES["kmeans_update_gather"] += 1
    return assign, sq_dist, sums, counts
