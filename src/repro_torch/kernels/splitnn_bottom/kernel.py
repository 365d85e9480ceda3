"""Wrappers of the CUDA SplitNN bottom kernels (``csrc/splitnn_bottom.cu``):
K1 ``splitnn_bottom_cuda``, the port of ``repro/kernels/splitnn_bottom/
kernel.py::splitnn_bottom_pallas``, K2 ``splitnn_bottom_gather_cuda``,
the port of ``::splitnn_bottom_gather_pallas``, and their int8 twins K9
(``::splitnn_bottom_int8_pallas``) and K10
(``::splitnn_bottom_int8_gather_pallas``).  Each pair comes in two forms,
instances of one template:

- K1/K2's f32 form (the TPU kernels' function, the f32 wire's pass) and
  their fp8 wire form, ``splitnn_bottom_fp8_cuda`` and
  ``splitnn_bottom_fp8_gather_cuda``, which the fp8 wire runs: the same
  f32 pass, then the wire rounding of ``quant.fake_quantize(·, "fp8")``
  in the epilogue, one launch a call (counted as ``splitnn_bottom_fp8``
  and ``splitnn_bottom_fp8_gather``);
- K9/K10's wire form, ``splitnn_bottom_int8_wire_cuda`` and
  ``splitnn_bottom_int8_wire_gather_cuda``, which the int8 wire runs
  (quantizers in the operand loads, the wire rounding in the epilogue,
  one launch a call; counted as ``splitnn_bottom_int8`` and
  ``splitnn_bottom_int8_gather``), and their operands form,
  ``splitnn_bottom_int8_cuda`` and ``splitnn_bottom_int8_gather_cuda``,
  the TPU kernels' function on operands quantized outside (counted as
  ``splitnn_bottom_int8_operands`` and
  ``splitnn_bottom_int8_gather_operands``).

The tensors come in unpadded; the kernels mask their own edges.  The
wrappers check what guards a pointer (CUDA, one device, contiguity,
dtype, shapes, shared memory) and launch through ``build.launch``."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.quant import QUANT_BLOCK_ROWS

#: bytes of shared memory a block may stage (``f32_smem_bytes``,
#: ``int8_smem_bytes``); wider layers raise instead of falling back
SMEM_CAP = 48 * 1024
#: threads a CTA (``THREADS`` in the source)
THREADS = 256


def rows_per_cta(o: int) -> int:
    """Rows a CTA of every form takes at output width ``o``: one thread
    an output, ``THREADS // o`` rows but at most ``THREADS // 2`` (so that
    the int8 wire form's quantizers, a thread a row and a thread a
    column, take one trip at o <= 2, and lr's eval block spreads over
    more CTAs: K1 at o = 1 is faster so, ``chip_bottom_f32.py``), rounded
    down to a multiple of the wire block's ``QUANT_BLOCK_ROWS``, and at
    least one block, so no wire block straddles two CTAs."""
    rows = min(THREADS // o, THREADS // 2)
    return max(QUANT_BLOCK_ROWS,
               rows // QUANT_BLOCK_ROWS * QUANT_BLOCK_ROWS)


def f32_smem_bytes(d: int, o: int, rows: int, gather: bool,
                   wire: bool) -> int:
    """Shared memory of a K1/K2 CTA of ``rows`` rows, as the source's
    ``carve`` lays it out: the bias, the indices (gather), the wire
    blocks' maxima and the outputs before the rounding (wire), and
    w[m]."""
    words = o + (rows if gather else 0) + d * o
    if wire:
        words += rows // QUANT_BLOCK_ROWS + rows * o
    return 4 * words


def int8_smem_bytes(d: int, o: int, rows: int, gather: bool,
                    wire: bool) -> int:
    """Shared memory of an int8 CTA of ``rows`` rows, as the source's
    ``carve`` lays it out: the column scales and bias, the row scales,
    the indices (gather); the wire blocks' maxima, the outputs before
    the rounding, w[m] in f32 and K9's f32 rows (wire); then wq[m] and
    the tile's int8 rows (wire)."""
    words = 2 * o + rows + (rows if gather else 0)
    if wire:
        words += (rows // QUANT_BLOCK_ROWS + rows * o + d * o
                  + (0 if gather else rows * d))
    return 4 * words + d * o + (rows * d if wire else 0)


def _shapes(name: str, x: torch.Tensor, w: torch.Tensor,
            b: torch.Tensor) -> tuple:
    """(M, N, d, o) of x (M, N, d), w (M, d, o), b (M, o)."""
    if x.dim() != 3 or w.dim() != 3 or b.dim() != 2:
        raise ValueError(f"{name}: expected x (M, N, d), w (M, d, o), "
                         f"b (M, o), got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}, {tuple(b.shape)}")
    m, n, d = x.shape
    o = w.shape[2]
    if w.shape != (m, d, o) or b.shape != (m, o):
        raise ValueError(f"{name}: w {tuple(w.shape)} and b "
                         f"{tuple(b.shape)} do not match x {tuple(x.shape)}")
    return m, n, d, o


def _smem_check(name: str, d: int, o: int, smem: int) -> None:
    if smem > SMEM_CAP:
        raise ValueError(f"{name}: a (d={d}, o={o}) block needs {smem} B "
                         f"of shared memory, over the {SMEM_CAP} B cap")


def _check(name: str, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
           gather: bool, wire: bool) -> tuple:
    """K1/K2's operands, f32 on one CUDA device, and the rows a CTA of
    the form takes: (M, N, d, o, rows)."""
    build.require_cuda(name, x, w, b, dtype=torch.float32)
    m, n, d, o = _shapes(name, x, w, b)
    rows = rows_per_cta(o)
    _smem_check(name, d, o, f32_smem_bytes(d, o, rows, gather, wire))
    return m, n, d, o, rows


def _int8_rows(name: str, d: int, o: int, gather: bool, wire: bool) -> int:
    """The rows an int8 CTA takes; raises where their shared memory
    passes ``SMEM_CAP``."""
    rows = rows_per_cta(o)
    _smem_check(name, d, o, int8_smem_bytes(d, o, rows, gather, wire))
    return rows


def _check_int8(name: str, xq: torch.Tensor, sx: torch.Tensor,
                wq: torch.Tensor, sw: torch.Tensor, b: torch.Tensor,
                bsz=None) -> tuple:
    """The operands form's int8 operands and their scales sx (M, B), B =
    ``bsz`` (the gather) or N, and sw (M, o): (M, N, d, o, rows a CTA)."""
    build.require_cuda(name, xq, wq, dtype=torch.int8)
    build.require_cuda(name, sx, sw, b, dtype=torch.float32)
    build.require_cuda(name, xq, sx)
    m, n, d, o = _shapes(name, xq, wq, b)
    rows = _int8_rows(name, d, o, bsz is not None, False)
    bsz = n if bsz is None else bsz
    if sx.shape != (m, bsz) or sw.shape != (m, o):
        raise ValueError(f"{name}: expected sx (M, B) = {(m, bsz)} and sw "
                         f"(M, o) = {(m, o)}, got {tuple(sx.shape)}, "
                         f"{tuple(sw.shape)}")
    return m, n, d, o, rows


def _check_idx(name: str, idx: torch.Tensor, x: torch.Tensor) -> int:
    build.require_cuda(name, idx, x)
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise ValueError(f"{name}: idx must be (B,) int32, "
                         f"got {idx.dtype}{list(idx.shape)}")
    return idx.shape[0]


def _wire_outputs(m: int, bsz: int, o: int, device, keep_pre: bool):
    out = torch.empty((m, bsz, o), dtype=torch.float32, device=device)
    pre = torch.empty_like(out) if keep_pre else None
    return out, pre, 0 if pre is None else pre.data_ptr()


def splitnn_bottom_cuda(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                        relu: bool) -> torch.Tensor:
    """K1: x (M, B, d), w (M, d, o), b (M, o) f32 on one CUDA device ->
    (M, B, o) f32, ``relu?(x[m] @ w[m] + b[m])``."""
    name = "splitnn_bottom"
    m, n, d, o, rows = _check(name, x, w, b, False, False)
    out = torch.empty((m, n, o), dtype=torch.float32, device=x.device)
    build.check(build.launch(
        build.function("splitnn_bottom", "splitnn_bottom_launch", 4, 6),
        x.device,
        x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, d,
        o, int(relu), rows), name)
    build.LAUNCHES[name] += 1
    return out


def splitnn_bottom_gather_cuda(idx: torch.Tensor, x: torch.Tensor,
                               w: torch.Tensor, b: torch.Tensor,
                               relu: bool) -> torch.Tensor:
    """K2: idx (B,) int32, x (M, N, d) the full slab, w (M, d, o), b
    (M, o) f32 on one CUDA device -> (M, B, o) f32 over the rows
    ``x[:, idx]``, bitwise K1 on those rows.  Every idx value must lie in
    [0, N); the kernel writes NaN for one that does not."""
    name = "splitnn_bottom_gather"
    m, n, d, o, rows = _check(name, x, w, b, True, False)
    bsz = _check_idx(name, idx, x)
    out = torch.empty((m, bsz, o), dtype=torch.float32, device=x.device)
    build.check(build.launch(
        build.function("splitnn_bottom", "splitnn_bottom_gather_launch", 5,
                       7), x.device,
        idx.data_ptr(), x.data_ptr(), w.data_ptr(), b.data_ptr(),
        out.data_ptr(), m, n, bsz, d, o, int(relu), rows), name)
    build.LAUNCHES[name] += 1
    return out


def splitnn_bottom_fp8_cuda(x: torch.Tensor, w: torch.Tensor,
                            b: torch.Tensor, relu: bool,
                            keep_pre: bool = False):
    """K1, the fp8 wire form: x (M, B, d), w (M, d, o), b (M, o) f32 on
    one CUDA device -> (wire, pre): K1's f32 pass, then the wire rounding
    of ``quant.fake_quantize(·, "fp8")``, in one launch.  ``pre`` (M, B,
    o) f32, bitwise K1's output, is written only with ``keep_pre`` (else
    None); ``wire`` is bitwise ``quant.fake_quantize(pre, "fp8")``."""
    name = "splitnn_bottom_fp8"
    m, n, d, o, rows = _check(name, x, w, b, False, True)
    out, pre, pre_ptr = _wire_outputs(m, n, o, x.device, keep_pre)
    build.check(build.launch(
        build.function("splitnn_bottom", "splitnn_bottom_fp8_launch", 5, 6),
        x.device, x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
        pre_ptr, m, n, d, o, int(relu), rows), name)
    build.LAUNCHES[name] += 1
    return out, pre


def splitnn_bottom_fp8_gather_cuda(idx: torch.Tensor, x: torch.Tensor,
                                   w: torch.Tensor, b: torch.Tensor,
                                   relu: bool, keep_pre: bool = False):
    """K2, the fp8 wire form: the fp8 wire K1 over the rows ``x[:, idx]``
    of the full (M, N, d) slab, gathered in the kernel -> (wire, pre),
    ``pre`` bitwise K2's output.  An idx value outside [0, N) writes NaN
    to both and stays out of its wire block's maximum."""
    name = "splitnn_bottom_fp8_gather"
    m, n, d, o, rows = _check(name, x, w, b, True, True)
    bsz = _check_idx(name, idx, x)
    out, pre, pre_ptr = _wire_outputs(m, bsz, o, x.device, keep_pre)
    build.check(build.launch(
        build.function("splitnn_bottom", "splitnn_bottom_fp8_gather_launch",
                       6, 7), x.device,
        idx.data_ptr(), x.data_ptr(), w.data_ptr(), b.data_ptr(),
        out.data_ptr(), pre_ptr, m, n, bsz, d, o, int(relu), rows), name)
    build.LAUNCHES[name] += 1
    return out, pre


def splitnn_bottom_int8_cuda(xq: torch.Tensor, sx: torch.Tensor,
                             wq: torch.Tensor, sw: torch.Tensor,
                             b: torch.Tensor, relu: bool) -> torch.Tensor:
    """K9, the operands form: xq (M, B, d) int8 with per-row scales sx
    (M, B) f32, wq (M, d, o) int8 with per-column scales sw (M, o) f32,
    b (M, o) f32 on one CUDA device -> (M, B, o) f32,
    ``relu?(i32(xq[m] @ wq[m]) * (sx·sw) + b)``, bitwise the plain
    version ``ref.splitnn_bottom_int8``."""
    name = "splitnn_bottom_int8"
    m, n, d, o, rows = _check_int8(name, xq, sx, wq, sw, b)
    out = torch.empty((m, n, o), dtype=torch.float32, device=xq.device)
    build.check(build.launch(
        build.function("splitnn_bottom", "splitnn_bottom_int8_launch", 6, 6),
        xq.device, xq.data_ptr(), sx.data_ptr(), wq.data_ptr(),
        sw.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, d, o, int(relu),
        rows), name)
    build.LAUNCHES["splitnn_bottom_int8_operands"] += 1
    return out


def splitnn_bottom_int8_gather_cuda(idx: torch.Tensor, xq: torch.Tensor,
                                    sx: torch.Tensor, wq: torch.Tensor,
                                    sw: torch.Tensor, b: torch.Tensor,
                                    relu: bool) -> torch.Tensor:
    """K10, the operands form: K9 over the rows ``xq[:, idx]`` of the
    full (M, N, d) int8 slab, gathered in the kernel; ``sx`` (M, B) holds
    the scales of the gathered rows (``sx_full[:, idx]``, gathered by the
    caller).  Bitwise K9 on the gathered rows; an idx value outside
    [0, N) writes NaN."""
    name = "splitnn_bottom_int8_gather"
    bsz = _check_idx(name, idx, xq)
    m, n, d, o, rows = _check_int8(name, xq, sx, wq, sw, b, bsz)
    out = torch.empty((m, bsz, o), dtype=torch.float32, device=xq.device)
    build.check(build.launch(
        build.function("splitnn_bottom",
                       "splitnn_bottom_int8_gather_launch", 7, 7),
        xq.device, idx.data_ptr(), xq.data_ptr(), sx.data_ptr(),
        wq.data_ptr(), sw.data_ptr(), b.data_ptr(), out.data_ptr(), m, n,
        bsz, d, o, int(relu), rows), name)
    build.LAUNCHES["splitnn_bottom_int8_gather_operands"] += 1
    return out


def splitnn_bottom_int8_wire_cuda(x: torch.Tensor, w: torch.Tensor,
                                  b: torch.Tensor, relu: bool,
                                  keep_pre: bool = False):
    """K9, the wire form: x (M, B, d), w (M, d, o), b (M, o) f32 on one
    CUDA device -> (wire, pre): x quantized by rows and w by columns in
    the kernel, the int8 pass, then the wire rounding of
    ``quant.fake_quantize(·, "int8")``, all in one launch; ``wire``
    (M, B, o) f32 is bitwise ``ref.splitnn_bottom_int8_wire(*int8_rows(x),
    w, b, relu)[0]``, and ``pre``, the output before the rounding, is
    written only with ``keep_pre`` (else None)."""
    name = "splitnn_bottom_int8_wire"
    build.require_cuda(name, x, w, b, dtype=torch.float32)
    m, n, d, o = _shapes(name, x, w, b)
    rows = _int8_rows(name, d, o, False, True)
    out, pre, pre_ptr = _wire_outputs(m, n, o, x.device, keep_pre)
    build.check(build.launch(
        build.function("splitnn_bottom", "splitnn_bottom_int8_wire_launch",
                       5, 6), x.device,
        x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), pre_ptr,
        m, n, d, o, int(relu), rows), name)
    build.LAUNCHES["splitnn_bottom_int8"] += 1
    return out, pre


def splitnn_bottom_int8_wire_gather_cuda(idx: torch.Tensor,
                                         xq: torch.Tensor, sx: torch.Tensor,
                                         w: torch.Tensor, b: torch.Tensor,
                                         relu: bool, keep_pre: bool = False):
    """K10, the wire form: the wire K9 over the rows ``xq[:, idx]`` of the
    run's int8 slab xq (M, N, d) with its row scales sx (M, N) f32
    (``ops.int8_rows`` of the slab), gathered in the kernel with their
    scales; w (M, d, o), b (M, o) f32 -> (wire, pre) as the wire K9,
    bitwise ``ref.splitnn_bottom_int8_wire(xq, sx, w, b, relu, idx)``.
    An idx value outside [0, N) writes NaN and stays out of its wire
    block's maximum."""
    name = "splitnn_bottom_int8_wire_gather"
    bsz = _check_idx(name, idx, xq)
    build.require_cuda(name, xq, dtype=torch.int8)
    build.require_cuda(name, sx, w, b, dtype=torch.float32)
    build.require_cuda(name, xq, sx)
    m, n, d, o = _shapes(name, xq, w, b)
    if sx.shape != (m, n):
        raise ValueError(f"{name}: expected the slab's row scales sx (M, N) "
                         f"= {(m, n)}, got {tuple(sx.shape)}")
    rows = _int8_rows(name, d, o, True, True)
    out, pre, pre_ptr = _wire_outputs(m, bsz, o, xq.device, keep_pre)
    build.check(build.launch(
        build.function("splitnn_bottom",
                       "splitnn_bottom_int8_wire_gather_launch", 7, 7),
        xq.device, idx.data_ptr(), xq.data_ptr(), sx.data_ptr(),
        w.data_ptr(), b.data_ptr(), out.data_ptr(), pre_ptr, m, n, bsz, d,
        o, int(relu), rows), name)
    build.LAUNCHES["splitnn_bottom_int8_gather"] += 1
    return out, pre
