"""Wrapper of the CUDA merge-path intersect (``csrc/sorted_intersect.cu``),
the port of ``repro/kernels/sorted_intersect/kernel.py::
sorted_intersect_pallas`` (K7) and, past the reference's single-pass
bound, of ``::sorted_intersect_tiled`` (K8).

The reference splits the merge into multi-pass cross/local stages once
P > ``SINGLE_PASS_MAX_P``, only because a 16 MB VMEM cannot hold the
single-pass block there.  The merge-path kernel has no such bound: one
CTA a tile of consecutive merged slots computes the same (sel, rank,
merged) at any P, in one launch a call.  So K8's counterpart is the same
kernel at P > ``SINGLE_PASS_MAX_P``; its launches there count as
``sorted_intersect_tiled``, so that a run can show which of the two
reference kernels it stood in for.

Each CTA merges one tile of ``threads * ITEMS`` consecutive merged slots
of one pair: one warp each finds the co-rank of the tile's first slot and
of the next tile's (32 probes a round, a ballot), the CTA stages the
tile's two windows in shared memory (their bodies as aligned 16-byte
words), each thread merges ``ITEMS`` slots there, and the outputs go out through shared memory in coalesced 16-byte
stores.  ``merge_geometry`` fixes the launch on the host from (pairs,
P): the CTA's threads (one of the source's instances), its tile, the
tiles a pair and the grid's rows."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.kernels import build

#: the reference's single-pass bound: K7 up to it, K8 past it
SINGLE_PASS_MAX_P = 1 << 18

SMS = 132                    # streaming multiprocessors of an H100 SXM
# the same constants as sorted_intersect.cu's (ITEMS; the launcher's
# instances; Smem)
ITEMS = 8                    # merged slots a thread
THREADS = (64, 256)          # a CTA's threads, one instance each
GRID_ROWS = 65_535           # the grid's y limit; more pairs loop
SMEM_MAX = 232_448           # bytes of shared memory a CTA may use


@dataclass(frozen=True)
class MergeGeometry:
    """One launch's cut of (pairs, 2P) merged slots: CTA (x, y) merges
    slots [x·tile, min((x+1)·tile, 2P)) of pairs y, y + rows, ...  The
    last tile of a pair is ragged where ``tile`` does not divide 2P."""
    threads: int
    tile: int
    tiles: int
    rows: int
    smem_bytes: int

    @property
    def ctas(self) -> int:
        return self.tiles * self.rows


def merge_smem_bytes(threads: int) -> int:
    """Shared memory of one CTA (``Smem`` in sorted_intersect.cu): the
    windows' keys (and a key of offset each, that keeps a key's place in
    its 16-byte word), aliased by the staged outputs (merged 2 a 16-byte
    word, rank and sel 4 a word, one word of padding after every 8),
    plus the two co-ranks and the halo key."""
    tile = threads * ITEMS
    padded = lambda w: w + w // 8
    staged = padded(tile // 2) + 2 * padded(tile // 4)
    return 16 * max(staged, tile // 2 + 1) + 2 * 4 + 8


def merge_geometry(pairs: int, p: int) -> MergeGeometry:
    """The launch for (pairs, P) keys: the largest tile that still gives
    two CTAs an SM (a CTA's two co-rank searches are paid once a tile,
    so larger tiles pay fewer; fewer CTAs than that leave SMs without
    one whose loads hide another's search), else the smallest.  On the
    H100 the HI rounds' one pair at P = 2^17 takes 64 threads (512 CTAs
    of 512 slots), the YP rounds' P = 2^19 256 (512 CTAs of 2,048):
    ``chip_merge.py --instances``."""
    fits = [t for t in THREADS
            if -(-2 * p // (t * ITEMS)) * pairs >= 2 * SMS]
    threads = max(fits) if fits else min(THREADS)
    tile = threads * ITEMS
    return MergeGeometry(threads=threads, tile=tile,
                         tiles=-(-2 * p // tile),
                         rows=min(pairs, GRID_ROWS),
                         smem_bytes=merge_smem_bytes(threads))


def sorted_intersect_cuda(a: torch.Tensor, b: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """a, b (pairs, P) int64 padded ascending keys on one CUDA device ->
    (sel, rank (pairs, 2P) int32, merged (pairs, 2P) int64); bitwise
    equal to ``ref.sorted_intersect``.  One launch, no scratch."""
    if a.dim() != 2 or a.shape != b.shape:
        raise ValueError(f"sorted_intersect: a and b must both be (pairs, "
                         f"P), got {tuple(a.shape)} and {tuple(b.shape)}")
    pairs, p = a.shape
    if 2 * p > 2 ** 31 - 1:
        raise ValueError(f"sorted_intersect: rank is int32, P={p} too large")
    build.require_cuda("sorted_intersect", a, b, dtype=torch.int64)
    sel = torch.empty((pairs, 2 * p), dtype=torch.int32, device=a.device)
    rank = torch.empty_like(sel)
    merged = torch.empty((pairs, 2 * p), dtype=torch.int64, device=a.device)
    fn = build.function("sorted_intersect", "sorted_intersect_launch", 5, 3)
    err = build.launch(fn, a.device,
                       a.data_ptr(), b.data_ptr(), sel.data_ptr(),
                       rank.data_ptr(), merged.data_ptr(), pairs, p,
                       merge_geometry(pairs, p).threads)
    build.check(err, "sorted_intersect")
    build.LAUNCHES["sorted_intersect_tiled" if p > SINGLE_PASS_MAX_P
                   else "sorted_intersect"] += 1
    return sel, rank, merged
