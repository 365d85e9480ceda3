"""Wrappers of the CUDA SplitNN bottom kernels (``csrc/splitnn_bottom.cu``):
K1 ``splitnn_bottom_cuda``, the port of ``repro/kernels/splitnn_bottom/
kernel.py::splitnn_bottom_pallas``, and K2 ``splitnn_bottom_gather_cuda``,
the port of ``::splitnn_bottom_gather_pallas``.  The tensors come in
unpadded; the kernels mask their own edges."""
from __future__ import annotations

import torch

from repro_torch.kernels import build

#: bytes of shared memory a block may stage (w[m], b[m] and, for K2, a
#: tile of 256 indices); wider layers raise instead of falling back
SMEM_CAP = 48 * 1024
_ROWS_PER_BLOCK_MAX = 256


def _check(name: str, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
           ) -> tuple:
    build.require_cuda(name, x, w, b, dtype=torch.float32)
    if x.dim() != 3 or w.dim() != 3 or b.dim() != 2:
        raise ValueError(f"{name}: expected x (M, N, d), w (M, d, o), "
                         f"b (M, o), got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}, {tuple(b.shape)}")
    m, n, d = x.shape
    o = w.shape[2]
    if w.shape != (m, d, o) or b.shape != (m, o):
        raise ValueError(f"{name}: w {tuple(w.shape)} and b "
                         f"{tuple(b.shape)} do not match x {tuple(x.shape)}")
    smem = (d * o + o + _ROWS_PER_BLOCK_MAX) * 4
    if smem > SMEM_CAP:
        raise ValueError(f"{name}: a (d={d}, o={o}) weight block needs "
                         f"{smem} B of shared memory, over the {SMEM_CAP} "
                         "B cap")
    return m, n, d, o


def splitnn_bottom_cuda(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                        relu: bool) -> torch.Tensor:
    """K1: x (M, B, d), w (M, d, o), b (M, o) f32 on one CUDA device ->
    (M, B, o) f32, ``relu?(x[m] @ w[m] + b[m])``."""
    m, n, d, o = _check("splitnn_bottom", x, w, b)
    out = torch.empty((m, n, o), dtype=torch.float32, device=x.device)
    fn = build.function("splitnn_bottom", "splitnn_bottom_launch", 4, 5)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                 m, n, d, o, int(relu),
                 torch.cuda.current_stream().cuda_stream)
    build.check(err, "splitnn_bottom")
    build.LAUNCHES["splitnn_bottom"] += 1
    return out


def splitnn_bottom_gather_cuda(idx: torch.Tensor, x: torch.Tensor,
                               w: torch.Tensor, b: torch.Tensor,
                               relu: bool) -> torch.Tensor:
    """K2: idx (B,) int32, x (M, N, d) the full slab, w (M, d, o), b
    (M, o) f32 on one CUDA device -> (M, B, o) f32 over the rows
    ``x[:, idx]``, bitwise K1 on those rows.  Every idx value must lie in
    [0, N); the kernel writes NaN for one that does not."""
    m, n, d, o = _check("splitnn_bottom_gather", x, w, b)
    build.require_cuda("splitnn_bottom_gather", idx, x)
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise ValueError("splitnn_bottom_gather: idx must be (B,) int32, "
                         f"got {idx.dtype}{list(idx.shape)}")
    bsz = idx.shape[0]
    out = torch.empty((m, bsz, o), dtype=torch.float32, device=x.device)
    fn = build.function("splitnn_bottom", "splitnn_bottom_gather_launch",
                        5, 6)
    with torch.cuda.device(x.device):
        err = fn(idx.data_ptr(), x.data_ptr(), w.data_ptr(), b.data_ptr(),
                 out.data_ptr(), m, n, bsz, d, o, int(relu),
                 torch.cuda.current_stream().cuda_stream)
    build.check(err, "splitnn_bottom_gather")
    build.LAUNCHES["splitnn_bottom_gather"] += 1
    return out
