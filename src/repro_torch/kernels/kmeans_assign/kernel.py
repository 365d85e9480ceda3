"""Wrapper of the CUDA k-means assign kernel (``csrc/kmeans_assign.cu``),
the port of ``repro/kernels/kmeans_assign/kernel.py::
kmeans_assign_pallas``.

One launch a call.  ``geometry`` fixes, from (M, N, K, d) alone, the rows
a thread holds, the tile and how the rows are cut among the CTAs."""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Tuple

import torch

from repro_torch.kernels import build

SMS = 132                    # streaming multiprocessors of an H100 SXM
# the same constants as kmeans_assign.cu's
THREADS = 128                # a CTA
D_FIXED = 32                 # widths with an instance of their own
#: CTAs an SM holds at the register cap of R rows a thread (``min_ctas``)
CTAS_PER_SM = {1: 8, 4: 3}
MIN_TILE = 32                # rows: the tile is halved down to it until
                             # the CTA fits shared memory
SMEM_MAX = 232_448           # bytes of shared memory a CTA may use
SMEM_SM = 233_472            # an SM's, of which each CTA reserves 1 KB


@dataclass(frozen=True)
class Geometry:
    """One launch's cut of ``n`` rows a client: ``ctas`` CTAs a client,
    CTA c taking rows [c·rows_per_cta, min((c+1)·rows_per_cta, n)) in
    tiles of ``tile`` rows from the first (its last one ragged), thread
    t holding a tile's rows t + i·THREADS for i < ``r``; ``per_sm`` CTAs
    an SM, each taking ``smem_bytes`` of shared memory."""
    r: int
    tile: int
    rows_per_cta: int
    ctas: int
    per_sm: int
    smem_bytes: int

    def row_ranges(self, n: int) -> List[Tuple[int, int]]:
        """Each CTA's rows, as [first, end)."""
        step = self.rows_per_cta
        return [(c * step, min((c + 1) * step, n)) for c in range(self.ctas)]


def _round4(x: int) -> int:
    return (x + 3) & ~3


def smem_bytes(tile: int, k: int, d: int) -> int:
    """Shared memory of one CTA (``smem_bytes`` in kmeans_assign.cu): the
    tile buffer of ``_round4(tile·d + 3)`` floats, the centroids at a row
    stride of ``_round4(d)`` floats, their norms (``_round4(K)`` floats)
    and the buffer's 8-byte mbarrier."""
    return 4 * (_round4(tile * d + 3) + k * _round4(d) + _round4(k)) + 8


def rows_per_thread(d: int) -> int:
    """R, the rows a thread holds in registers: 4 at widths up to
    ``D_FIXED``; 1 past it, where rows stay in shared memory."""
    return 4 if d <= D_FIXED else 1


def geometry(m: int, n: int, k: int, d: int) -> Geometry:
    """The launch geometry of an assignment of ``n`` rows of each of
    ``m`` clients: R = ``rows_per_thread(d)`` and tiles of THREADS·R
    rows, halved down to ``MIN_TILE`` until the CTA fits shared memory;
    as many CTAs as the card holds at once (``per_sm`` an SM), each an
    equal contiguous range of rows (a multiple of 32, the last CTA's
    ragged)."""
    r = rows_per_thread(d)
    tiles = [THREADS * r >> i for i in range((THREADS * r // MIN_TILE)
                                             .bit_length())]
    tile = next((t for t in tiles if smem_bytes(t, k, d) <= SMEM_MAX),
                tiles[-1])                     # else the launch refuses
    smem = smem_bytes(tile, k, d)
    per_sm = max(1, min(CTAS_PER_SM[r], SMEM_SM // (smem + 1024)))
    cap = max(1, SMS * per_sm // max(m, 1))
    rows_per_cta = 32 * max(1, math.ceil(n / (32 * cap)))
    return Geometry(r=r, tile=tile, rows_per_cta=rows_per_cta,
                    ctas=max(1, math.ceil(n / rows_per_cta)), per_sm=per_sm,
                    smem_bytes=smem)


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
    geo = geometry(m, n, k, d)
    assign = torch.empty((m, n), dtype=torch.int32, device=points.device)
    sq_dist = torch.empty((m, n), dtype=torch.float32, device=points.device)
    fn = build.function("kmeans_assign", "kmeans_assign_launch", 4, 9)
    err = build.launch(fn, points.device,
                       points.data_ptr(), centroids.data_ptr(),
                       assign.data_ptr(), sq_dist.data_ptr(), m, n, k, k, d,
                       geo.r, geo.tile, geo.rows_per_cta, geo.ctas)
    build.check(err, "kmeans_assign")
    build.LAUNCHES["kmeans_assign"] += 1
    return assign, sq_dist
