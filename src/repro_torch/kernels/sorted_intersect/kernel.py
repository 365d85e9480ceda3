"""Wrapper of the CUDA merge-path intersect (``csrc/sorted_intersect.cu``),
the port of ``repro/kernels/sorted_intersect/kernel.py::
sorted_intersect_pallas``."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build


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
    sel = torch.empty((pairs, 2 * p), dtype=torch.int32, device=a.device)
    rank = torch.empty_like(sel)
    merged = torch.empty((pairs, 2 * p), dtype=torch.int64, device=a.device)
    fn = build.function("sorted_intersect", "sorted_intersect_launch", 5, 2)
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), b.data_ptr(), sel.data_ptr(), rank.data_ptr(),
                 merged.data_ptr(), pairs, p,
                 torch.cuda.current_stream().cuda_stream)
    build.check(err, "sorted_intersect")
    build.LAUNCHES["sorted_intersect"] += 1
    return sel, rank, merged
