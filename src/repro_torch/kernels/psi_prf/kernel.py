"""Wrapper of the CUDA PSI tag PRF (``csrc/psi_prf.cu``), the port of
``repro/kernels/psi_prf/kernel.py::prf_tags_pallas``."""
from __future__ import annotations

import torch

from repro_torch.kernels import build


def smem_bytes() -> int:
    """Shared memory of one CTA: none.  ``prf_kernel`` tags one id a
    thread (256 a CTA) in registers, its five round keys constants."""
    return 0


def prf_tags_cuda(ids: torch.Tensor, seeds: torch.Tensor) -> torch.Tensor:
    """ids (R, N) int64 and seeds (R, 2) int64 (u32 words) on one CUDA
    device -> tags (R, N) int64; bitwise equal to ``ref.prf_tags``."""
    build.require_cuda("psi_prf", ids, seeds, dtype=torch.int64)
    if ids.dim() != 2 or seeds.shape != (ids.shape[0], 2):
        raise ValueError(f"psi_prf: ids (R, N) and seeds (R, 2), got "
                         f"{tuple(ids.shape)} and {tuple(seeds.shape)}")
    words = seeds & 0xFFFFFFFF
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    words = words.to(torch.int32).contiguous()     # the u32 bit patterns
    tags = torch.empty_like(ids)
    fn = build.function("psi_prf", "psi_prf_launch", 3, 2)
    err = build.launch(fn, ids.device,
                       ids.data_ptr(), words.data_ptr(), tags.data_ptr(),
                       ids.shape[0], ids.shape[1])
    build.check(err, "psi_prf")
    build.LAUNCHES["psi_prf"] += 1
    return tags
