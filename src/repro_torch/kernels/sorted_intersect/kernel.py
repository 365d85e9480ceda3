"""Wrapper of the CUDA merge-path intersect (``csrc/sorted_intersect.cu``),
the port of ``repro/kernels/sorted_intersect/kernel.py::
sorted_intersect_pallas`` (K7) and, past the reference's single-pass
bound, of ``::sorted_intersect_tiled`` (K8).

The reference splits the merge into multi-pass cross/local stages once
P > ``SINGLE_PASS_MAX_P``, only because a 16 MB VMEM cannot hold the
single-pass block there.  The merge-path kernel has no such bound: one
thread per merged slot computes the same (sel, rank, merged) at any P.
So K8's counterpart is the same kernel at P > ``SINGLE_PASS_MAX_P``; its
launches there count as ``sorted_intersect_tiled``, so that a run can
show which of the two reference kernels it stood in for."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build

#: the reference's single-pass bound: K7 up to it, K8 past it
SINGLE_PASS_MAX_P = 1 << 18


def sorted_intersect_cuda(a: torch.Tensor, b: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """a, b (pairs, P) int64 padded ascending keys on one CUDA device ->
    (sel, rank (pairs, 2P) int32, merged (pairs, 2P) int64); bitwise
    equal to ``ref.sorted_intersect``."""
    build.require_cuda("sorted_intersect", a, b, dtype=torch.int64)
    if a.dim() != 2 or a.shape != b.shape:
        raise ValueError(f"sorted_intersect: a and b must both be (pairs, "
                         f"P), got {tuple(a.shape)} and {tuple(b.shape)}")
    pairs, p = a.shape
    if 2 * p > 2 ** 31 - 1:
        raise ValueError(f"sorted_intersect: rank is int32, P={p} too large")
    sel = torch.empty((pairs, 2 * p), dtype=torch.int32, device=a.device)
    rank = torch.empty_like(sel)
    merged = torch.empty((pairs, 2 * p), dtype=torch.int64, device=a.device)
    fn = build.function("sorted_intersect", "sorted_intersect_launch", 5, 2)
    err = build.launch(fn, a.device,
                       a.data_ptr(), b.data_ptr(), sel.data_ptr(),
                       rank.data_ptr(), merged.data_ptr(), pairs, p)
    build.check(err, "sorted_intersect")
    build.LAUNCHES["sorted_intersect_tiled" if p > SINGLE_PASS_MAX_P
                   else "sorted_intersect"] += 1
    return sel, rank, merged
