"""Wrappers of the CUDA SplitNN bottom kernels (``csrc/splitnn_bottom.cu``):
K1 ``splitnn_bottom_cuda``, the port of ``repro/kernels/splitnn_bottom/
kernel.py::splitnn_bottom_pallas``, K2 ``splitnn_bottom_gather_cuda``,
the port of ``::splitnn_bottom_gather_pallas``, and their int8 twins K9
``splitnn_bottom_int8_cuda`` (``::splitnn_bottom_int8_pallas``) and K10
``splitnn_bottom_int8_gather_cuda``
(``::splitnn_bottom_int8_gather_pallas``).  The tensors come in
unpadded; the kernels mask their own edges."""
from __future__ import annotations

import torch

from repro_torch.kernels import build

#: bytes of shared memory a block may stage (w[m], b[m], for K9/K10
#: sw[m], and a tile of up to 256 indices); wider layers raise instead of
#: falling back
SMEM_CAP = 48 * 1024
_ROWS_PER_BLOCK_MAX = 256


def _shape_check(name: str, x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor, w_bytes: int, o_vectors: int) -> tuple:
    """(M, N, d, o) of x (M, N, d), w (M, d, o), b (M, o); raises where
    the block's staging (w[m] of ``w_bytes`` elements, ``o_vectors`` f32
    vectors of length o, a tile of indices) passes ``SMEM_CAP``."""
    if x.dim() != 3 or w.dim() != 3 or b.dim() != 2:
        raise ValueError(f"{name}: expected x (M, N, d), w (M, d, o), "
                         f"b (M, o), got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}, {tuple(b.shape)}")
    m, n, d = x.shape
    o = w.shape[2]
    if w.shape != (m, d, o) or b.shape != (m, o):
        raise ValueError(f"{name}: w {tuple(w.shape)} and b "
                         f"{tuple(b.shape)} do not match x {tuple(x.shape)}")
    smem = d * o * w_bytes + (o_vectors * o + _ROWS_PER_BLOCK_MAX) * 4
    if smem > SMEM_CAP:
        raise ValueError(f"{name}: a (d={d}, o={o}) weight block needs "
                         f"{smem} B of shared memory, over the {SMEM_CAP} "
                         "B cap")
    return m, n, d, o


def _check(name: str, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
           ) -> tuple:
    build.require_cuda(name, x, w, b, dtype=torch.float32)
    return _shape_check(name, x, w, b, 4, 1)


def _check_int8(name: str, xq: torch.Tensor, sx: torch.Tensor,
                wq: torch.Tensor, sw: torch.Tensor, b: torch.Tensor,
                bsz=None) -> tuple:
    """``_check`` for the int8 operands and their scales sx (M, B), B =
    ``bsz`` or N, and sw (M, o); the block stages w[m] in bytes and
    sw[m], b[m] in f32."""
    build.require_cuda(name, xq, wq, dtype=torch.int8)
    build.require_cuda(name, sx, sw, b, dtype=torch.float32)
    build.require_cuda(name, xq, sx)
    m, n, d, o = _shape_check(name, xq, wq, b, 1, 2)
    bsz = n if bsz is None else bsz
    if sx.shape != (m, bsz) or sw.shape != (m, o):
        raise ValueError(f"{name}: expected sx (M, B) = {(m, bsz)} and sw "
                         f"(M, o) = {(m, o)}, got {tuple(sx.shape)}, "
                         f"{tuple(sw.shape)}")
    return m, n, d, o


def _check_idx(name: str, idx: torch.Tensor, x: torch.Tensor) -> int:
    build.require_cuda(name, idx, x)
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise ValueError(f"{name}: idx must be (B,) int32, "
                         f"got {idx.dtype}{list(idx.shape)}")
    return idx.shape[0]


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def splitnn_bottom_cuda(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                        relu: bool) -> torch.Tensor:
    """K1: x (M, B, d), w (M, d, o), b (M, o) f32 on one CUDA device ->
    (M, B, o) f32, ``relu?(x[m] @ w[m] + b[m])``."""
    m, n, d, o = _check("splitnn_bottom", x, w, b)
    out = torch.empty((m, n, o), dtype=torch.float32, device=x.device)
    fn = build.function("splitnn_bottom", "splitnn_bottom_launch", 4, 5)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                 m, n, d, o, int(relu), _stream())
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
    bsz = _check_idx("splitnn_bottom_gather", idx, x)
    out = torch.empty((m, bsz, o), dtype=torch.float32, device=x.device)
    fn = build.function("splitnn_bottom", "splitnn_bottom_gather_launch",
                        5, 6)
    with torch.cuda.device(x.device):
        err = fn(idx.data_ptr(), x.data_ptr(), w.data_ptr(), b.data_ptr(),
                 out.data_ptr(), m, n, bsz, d, o, int(relu), _stream())
    build.check(err, "splitnn_bottom_gather")
    build.LAUNCHES["splitnn_bottom_gather"] += 1
    return out


def splitnn_bottom_int8_cuda(xq: torch.Tensor, sx: torch.Tensor,
                             wq: torch.Tensor, sw: torch.Tensor,
                             b: torch.Tensor, relu: bool) -> torch.Tensor:
    """K9: xq (M, B, d) int8 with per-row scales sx (M, B) f32, wq
    (M, d, o) int8 with per-column scales sw (M, o) f32, b (M, o) f32 on
    one CUDA device -> (M, B, o) f32,
    ``relu?(i32(xq[m] @ wq[m]) * (sx·sw) + b)``, bitwise the plain
    version ``ref.splitnn_bottom_int8``."""
    m, n, d, o = _check_int8("splitnn_bottom_int8", xq, sx, wq, sw, b)
    out = torch.empty((m, n, o), dtype=torch.float32, device=xq.device)
    fn = build.function("splitnn_bottom", "splitnn_bottom_int8_launch", 6, 5)
    with torch.cuda.device(xq.device):
        err = fn(xq.data_ptr(), sx.data_ptr(), wq.data_ptr(), sw.data_ptr(),
                 b.data_ptr(), out.data_ptr(), m, n, d, o, int(relu),
                 _stream())
    build.check(err, "splitnn_bottom_int8")
    build.LAUNCHES["splitnn_bottom_int8"] += 1
    return out


def splitnn_bottom_int8_gather_cuda(idx: torch.Tensor, xq: torch.Tensor,
                                    sx: torch.Tensor, wq: torch.Tensor,
                                    sw: torch.Tensor, b: torch.Tensor,
                                    relu: bool) -> torch.Tensor:
    """K10: K9 over the rows ``xq[:, idx]`` of the full (M, N, d) int8
    slab, gathered in the kernel; ``sx`` (M, B) holds the scales of the
    gathered rows (``sx_full[:, idx]``, gathered by the caller).
    Bitwise K9 on the gathered rows; an idx value outside [0, N) writes
    NaN."""
    bsz = _check_idx("splitnn_bottom_int8_gather", idx, xq)
    m, n, d, o = _check_int8("splitnn_bottom_int8_gather", xq, sx, wq, sw,
                             b, bsz)
    out = torch.empty((m, bsz, o), dtype=torch.float32, device=xq.device)
    fn = build.function("splitnn_bottom",
                        "splitnn_bottom_int8_gather_launch", 7, 6)
    with torch.cuda.device(xq.device):
        err = fn(idx.data_ptr(), xq.data_ptr(), sx.data_ptr(),
                 wq.data_ptr(), sw.data_ptr(), b.data_ptr(), out.data_ptr(),
                 m, n, bsz, d, o, int(relu), _stream())
    build.check(err, "splitnn_bottom_int8_gather")
    build.LAUNCHES["splitnn_bottom_int8_gather"] += 1
    return out
