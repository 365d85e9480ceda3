"""Wrappers of the CUDA fused Lloyd step (``csrc/kmeans_update.cu``): K3
``kmeans_update_cuda``, the port of ``repro/kernels/kmeans_update/
kernel.py::kmeans_update_pallas``, and K4 ``kmeans_update_gather_cuda``,
the port of ``::kmeans_update_gather_pallas``.

Both launch one kernel a call.  ``geometry`` fixes how the rows are cut
into tiles and CTAs from (M, rows, K, d) alone, so K4 gets K3's geometry
for the same row count and the order of every sum is fixed."""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.kernels import build

SMS = 132                    # streaming multiprocessors of an H100 SXM
# the same constants as kmeans_update.cu's (CTAS_PER_SM: MIN_CTAS_PER_SM)
CTAS_PER_SM = 8              # CTAs an SM holds, at 64 registers a thread
THREADS = 128                # a CTA
TILE_ROWS = (128, 64, 32)    # rows a tile, the largest that fits
GROUP = 16                   # CTAs whose partials one CTA adds first
RED_STAGE = 16               # partial rows the reduce stages, if they fit
SMEM_MAX = 232_448           # bytes of shared memory a CTA may use
SMEM_SM = 233_472            # an SM's, of which each CTA reserves 1 KB


@dataclass(frozen=True)
class Geometry:
    """One launch's cut of ``rows`` rows a client: ``n_tiles`` tiles of
    ``tile`` rows (the last one ragged), ``ctas`` CTAs a client, CTA c
    taking tiles [c·tiles_per_cta, min((c+1)·tiles_per_cta, n_tiles)).
    Each CTA writes a partial row of ``width`` = K·d + K floats (at a
    stride of ``row`` floats, a multiple of 4 for 16-byte copies); CTAs
    c with c // GROUP = g form group g, whose sum is one more row."""
    tile: int
    n_tiles: int
    tiles_per_cta: int
    ctas: int
    width: int
    smem_bytes: int

    @property
    def groups(self) -> int:
        return -(-self.ctas // GROUP)

    @property
    def row(self) -> int:
        return _round4(self.width)

    def tile_ranges(self) -> List[Tuple[int, int]]:
        """Each CTA's tiles, as [first, end)."""
        step = self.tiles_per_cta
        return [(c * step, min((c + 1) * step, self.n_tiles))
                for c in range(self.ctas)]


def _round4(x: int) -> int:
    return (x + 3) & ~3


def smem_bytes(tile: int, k: int, d: int) -> int:
    """Shared memory of one CTA (``smem_words`` and ``stage_rows`` in
    kmeans_update.cu): the stage (two tile buffers of
    ``_round4(tile·d + 3)`` floats, and ``RED_STAGE`` partial rows where
    that fits, else one), centroids, their norms, the CTA's sums; two
    tiles' source rows, the sorted order, the (cluster, warp) offsets
    and the ticket flag."""
    def words(rows):
        stage = max(2 * _round4(tile * d + 3), rows * _round4(k * d + k))
        return stage + 2 * k * d + 2 * k + 3 * tile + k * (tile // 32) + 2
    full = 4 * words(RED_STAGE)
    return full if full <= SMEM_MAX else 4 * words(1)


def ctas_cap(m: int, tile: int, k: int, d: int) -> int:
    """CTAs a client may have: as many as the card holds at once, over
    ``m`` clients (``CTAS_PER_SM`` an SM, fewer where shared memory
    binds)."""
    per_sm = min(CTAS_PER_SM, SMEM_SM // (smem_bytes(tile, k, d) + 1024))
    return max(1, SMS * max(per_sm, 1) // max(m, 1))


def geometry(m: int, rows: int, k: int, d: int) -> Geometry:
    """The launch geometry of a step over ``rows`` rows of each of ``m``
    clients: tiles of the largest of ``TILE_ROWS`` rows that fits shared
    memory, at most ``ctas_cap`` CTAs a client, each a contiguous
    ascending range of whole tiles.  A minibatch of up to ``GROUP``
    tiles is one tile a CTA in a single group: one level of reduce."""
    fits = [t for t in TILE_ROWS if smem_bytes(t, k, d) <= SMEM_MAX]
    tile = fits[0] if fits else TILE_ROWS[-1]   # else the launch refuses
    n_tiles = max(1, math.ceil(rows / tile))
    per_cta = math.ceil(n_tiles / ctas_cap(m, tile, k, d))
    return Geometry(tile=tile, n_tiles=n_tiles, tiles_per_cta=per_cta,
                    ctas=math.ceil(n_tiles / per_cta), width=k * d + k,
                    smem_bytes=smem_bytes(tile, k, d))


#: per (device, stream): the int32 ticket counters (a client's, then its
#: groups'), zeroed once; each launch leaves them zero for the next one
#: on its stream
_TICKETS: Dict[Tuple[int, int], torch.Tensor] = {}


def _tickets(dev: torch.device, size: int) -> torch.Tensor:
    key = (dev.index, build.stream(dev))
    buf = _TICKETS.get(key)
    if buf is None or buf.numel() < size:
        buf = _TICKETS[key] = torch.zeros(size, dtype=torch.int32,
                                          device=dev)
    return buf


def _outputs(name: str, points: torch.Tensor, centroids: torch.Tensor,
             rows: int, clients: Optional[int] = None):
    """Check the operands; the geometry (cut for ``clients`` clients, M
    by default), the outputs of a step over ``rows`` rows a client, the
    partials scratch and the tickets."""
    build.require_cuda(name, points, centroids, dtype=torch.float32)
    m, n, d = points.shape
    k = centroids.shape[1]
    if centroids.shape != (m, k, d):
        raise ValueError(f"{name}: centroids {tuple(centroids.shape)}"
                         f" do not match points {tuple(points.shape)}")
    geo = geometry(clients or m, rows, k, d)
    dev = points.device
    return (m, n, d, k, geo,
            torch.empty((m, rows), dtype=torch.int32, device=dev),
            torch.empty((m, rows), dtype=torch.float32, device=dev),
            torch.empty((m, geo.ctas + geo.groups, geo.row),
                        dtype=torch.float32, device=dev),
            _tickets(dev, m * (1 + geo.groups)),
            torch.empty((m, k, d), dtype=torch.float32, device=dev),
            torch.empty((m, k), dtype=torch.float32, device=dev))


def kmeans_update_cuda(points: torch.Tensor, centroids: torch.Tensor,
                       clients: Optional[int] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                  torch.Tensor]:
    """K3: points (M, N, d), centroids (M, K, d) f32 on one CUDA device ->
    (assign (M, N) int32, sq_dist (M, N) f32, sums (M, K, d) f32,
    counts (M, K) f32).  Sums are added in an order fixed by
    ``geometry(clients or M, ...)``, so two runs give the same bits, and
    a batch of some of the clients launched with the whole batch's
    ``clients`` gives each of them the whole batch's bits."""
    (m, n, d, k, geo, assign, sq_dist, partials, tickets, sums,
     counts) = _outputs("kmeans_update", points, centroids, points.shape[1],
                        clients)
    fn = build.function("kmeans_update", "kmeans_update_launch", 8, 8)
    err = build.launch(fn, points.device,
                       points.data_ptr(), centroids.data_ptr(),
                       assign.data_ptr(), sq_dist.data_ptr(),
                       partials.data_ptr(), tickets.data_ptr(),
                       sums.data_ptr(), counts.data_ptr(), m, n, k, k, d,
                       geo.tile, geo.tiles_per_cta, geo.ctas)
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
    (m, n, d, k, geo, assign, sq_dist, partials, tickets, sums,
     counts) = _outputs("kmeans_update_gather", points, centroids,
                        idx.shape[1])
    fn = build.function("kmeans_update", "kmeans_update_gather_launch", 9, 9)
    err = build.launch(fn, points.device,
                       idx.data_ptr(), points.data_ptr(),
                       centroids.data_ptr(), assign.data_ptr(),
                       sq_dist.data_ptr(), partials.data_ptr(),
                       tickets.data_ptr(), sums.data_ptr(), counts.data_ptr(),
                       m, n, idx.shape[1], k, k, d, geo.tile,
                       geo.tiles_per_cta, geo.ctas)
    build.check(err, "kmeans_update_gather")
    build.LAUNCHES["kmeans_update_gather"] += 1
    return assign, sq_dist, sums, counts
