"""Wrapper of the CUDA SSD scan kernel K12 (``csrc/ssd_scan.cu``), the
port of ``repro/kernels/ssd_scan/kernel.py::ssd_scan_pallas``.  The
tensors come in the framework layout, unpadded: rows past S read as
zeros with dt = 0 inside the kernel, the reference wrapper's padding.
One call makes two CUDA launches (C Bᵀ per chunk, then the chunks,
which pass the state on in chunk order) and counts once in
``build.LAUNCHES["ssd_scan"]``; the wrapper allocates their scratch."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build

#: the kernel's limits: its shared-memory tiles cover P <= 64, N <= 128
#: and chunks of L <= 128 (every Mamba2 config: P = 64 or 32, N <= 128, L
#: = 128); a chunk CTA then takes 104 KB of shared memory (two an SM), a
#: C Bᵀ CTA 73 KB
MAX_P, MAX_N, MAX_CHUNK = 64, 128, 128
# the source's tile strides (floats): the 128-wide tiles' rows (``RS``)
# and the P-wide tiles' (``XS``)
_RS, _XS = 132, MAX_P + 8


def smem_bytes(p: int, n: int, chunk: int) -> Tuple[int, int]:
    """Shared memory of one CTA of each of K12's two kernels, (C Bᵀ,
    chunk), as ``ssd_scan.cu`` lays it out: the tiles are sized for the
    limits, so every (P, N, L) within them takes the same.  C Bᵀ
    (``CB_SMEM``, dynamic): 16 C rows and L_MAX B rows at a stride of RS
    floats.  Chunk (``CHUNK_SMEM``, dynamic, plus the static ticket
    ``item_s``): L_MAX rows of x at XS, L_MAX rows of B at RS, and cum, dt
    and the decays, L_MAX floats each.  Raises outside the limits, as
    the wrapper does."""
    if not (0 < p <= MAX_P and 0 < n <= MAX_N and 0 < chunk <= MAX_CHUNK):
        raise ValueError(f"ssd_scan: (P={p}, N={n}, L={chunk}) is out of "
                         f"the kernel's range")
    cb = 4 * (16 + MAX_CHUNK) * _RS
    chunk_cta = 4 * (MAX_CHUNK * _XS + MAX_CHUNK * _RS + 3 * MAX_CHUNK) + 4
    return cb, chunk_cta


def ssd_scan_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor, *, chunk: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K12: x (B,S,H,P), dt (B,S,H), A (H,), B/C (B,S,N), f32 on one CUDA
    device -> (y (B,S,H,P), final_state (B,H,P,N)), chunks of ``chunk``
    rows.  Forward only: raises under grad mode if an operand requires
    grad."""
    build.refuse_grad("ssd_scan", x, dt, A, B, C)
    build.require_cuda("ssd_scan", x, dt, A, B, C, dtype=torch.float32)
    if x.dim() != 4:
        raise ValueError(f"ssd_scan: expected x (B,S,H,P), got "
                         f"{tuple(x.shape)}")
    bsz, s, h, p = x.shape
    n = B.shape[-1]
    if (dt.shape != (bsz, s, h) or A.shape != (h,)
            or B.shape != (bsz, s, n) or C.shape != B.shape):
        raise ValueError(f"ssd_scan: dt {tuple(dt.shape)}, A "
                         f"{tuple(A.shape)}, B {tuple(B.shape)}, C "
                         f"{tuple(C.shape)} do not match x {tuple(x.shape)}")
    if not (0 < p <= MAX_P and 0 < n <= MAX_N and 0 < chunk <= MAX_CHUNK):
        raise ValueError(f"ssd_scan: (P={p}, N={n}, L={chunk}) is out of "
                         f"the kernel's range (P <= {MAX_P}, N <= {MAX_N}, "
                         f"L <= {MAX_CHUNK})")
    y = torch.empty_like(x)
    fs = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    if s == 0:
        return y, fs.zero_()
    # scratch: the state after each chunk (transposed), a flag per chunk
    # and a ticket (cleared by the first launch), and per chunk (C Bᵀ)ᵀ at
    # L rounded up to 16, Cᵀ, then each head's dt and cum
    nc, lp = -(-s // chunk), -(-chunk // 16) * 16
    st = torch.empty((bsz, nc, h, n, p), dtype=torch.float32,
                     device=x.device)
    flags = torch.empty(bsz * nc * h + 1, dtype=torch.int32, device=x.device)
    cb = torch.empty((bsz, nc, lp + n + 2 * h, lp), dtype=torch.float32,
                     device=x.device)
    fn = build.function("ssd_scan", "ssd_scan_launch", 10, 6)
    err = build.launch(fn, x.device,
                       x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                       B.data_ptr(), C.data_ptr(), y.data_ptr(),
                       fs.data_ptr(), st.data_ptr(), flags.data_ptr(),
                       cb.data_ptr(), bsz, s, h, p, n, chunk)
    build.check(err, "ssd_scan")
    build.LAUNCHES["ssd_scan"] += 1
    return y, fs
