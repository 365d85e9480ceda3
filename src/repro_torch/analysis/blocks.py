"""Shared memory a CTA for every CUDA kernel of the port, at the shapes
the engines run (the counterpart of ``repro.analysis.blocks``' Pallas
VMEM footprints).

A TPU kernel's resident set is a function of its BlockSpecs; a CUDA
kernel's is what its CTA stages in shared memory, which each kernel
module already computes from the shape, as its source lays it out
(``f32_smem_bytes``/``int8_smem_bytes``, ``kmeans_update.smem_bytes``,
``kmeans_assign.smem_bytes``, ``merge_smem_bytes``, ``psi_prf``,
``flash_attention`` and ``ssd_scan``'s ``smem_bytes``).  This module
calls those functions and duplicates no arithmetic: each row is one
kernel at one shape, its shared memory a CTA, the limit it is held to
(``SMEM_LIMIT``, 232,448 bytes a CTA on the H100, or the kernel's own
cap: the SplitNN bottom's ``SMEM_CAP``) and ``ok``.  A row that is not
``ok`` is a shape the kernel's wrapper refuses before launch.

The reference's rows take the TPU's 128-lane padded widths; the port's
kernels take unpadded ones, so its SplitNN rows keep the reference's B
and d at the bottom widths the engines run (o = 8, the mlp's; the
reference pads it to 128).  At d = o = 128 the port's K1 stages a 64 KB
w[m] and refuses (``SMEM_CAP``).

The reference's gather rows test a fallback: past ``GATHER_VMEM_BUDGET``
the whole (N, d) slab no longer fits VMEM, and its wrapper gathers
first.  The port's K2/K4/K10 read the gathered rows from global memory,
so N does not enter their shared memory and the port has no such
fallback: the rows at ``budget_rows`` and ``budget_rows + 1`` are both
``ok``, with the same bytes.

Each row carries ``params``, the shape a launch takes (``chip_smoke.py``
launches every ``ok`` row and holds it against its plain version).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import torch

from repro_torch.kernels.flash_attention import kernel as fa
from repro_torch.kernels.kmeans_assign import kernel as assign
from repro_torch.kernels.kmeans_update import kernel as update
from repro_torch.kernels.psi_prf import kernel as prf
from repro_torch.kernels.sorted_intersect import kernel as merge
from repro_torch.kernels.splitnn_bottom import kernel as bottom
from repro_torch.kernels.ssd_scan import kernel as ssd

__all__ = ["SMEM_LIMIT", "GATHER_VMEM_BUDGET", "BlockReport",
           "splitnn_bottom_blocks", "splitnn_bottom_gather_blocks",
           "kmeans_update_blocks", "kmeans_update_gather_blocks",
           "kmeans_assign_blocks", "psi_prf_blocks",
           "sorted_intersect_blocks", "flash_attention_blocks",
           "flash_attention_bwd_blocks", "ssd_scan_blocks", "smem_report"]

SMEM_LIMIT = 232_448     # bytes of shared memory a CTA may use (H100)
#: the reference's gather budget (``repro/kernels/padding.py``), kept only
#: to place the gather rows where the reference's fallback starts
GATHER_VMEM_BUDGET = 12 * 2 ** 20
F32 = 4


@dataclasses.dataclass
class BlockReport:
    kernel: str
    shape: str                       # human-readable shape key
    smem_bytes: int                  # shared memory a CTA
    limit: int                       # the limit this kernel is held to
    note: str = ""
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return self.smem_bytes <= self.limit

    def as_row(self) -> Dict[str, object]:
        return {"kernel": self.kernel, "shape": self.shape,
                "smem_bytes": self.smem_bytes, "limit": self.limit,
                "ok": self.ok, "note": self.note, "params": self.params}


def _shape(**kw) -> str:
    return ",".join(f"{k}={v}" for k, v in kw.items())


def splitnn_bottom_blocks(b: int, d: int, o: int, m: int = 3,
                          quant: str = None) -> BlockReport:
    """K1 (or, ``quant="int8"``, K9 in the wire form the int8 wire runs)
    over an (M, B, d) slab: a CTA of ``rows_per_cta(o)`` rows stages the
    bias and w[m] (and K9's scales, its f32 and int8 rows)."""
    rows = bottom.rows_per_cta(o)
    if quant == "int8":
        tag, smem = "splitnn_bottom_int8", bottom.int8_smem_bytes(
            d, o, rows, False, True)
    else:
        tag, smem = "splitnn_bottom", bottom.f32_smem_bytes(
            d, o, rows, False, False)
    return BlockReport(tag, _shape(M=m, B=b, d=d, o=o, rows=rows), smem,
                       bottom.SMEM_CAP,
                       params=dict(m=m, n=b, d=d, o=o, quant=quant))


def splitnn_bottom_gather_blocks(n: int, d: int, o: int, b: int,
                                 m: int = 1, quant: str = None
                                 ) -> BlockReport:
    """K2 (or K10 in its wire form) over B rows gathered from an (M, N,
    d) slab: N does not enter the CTA's shared memory."""
    rows = bottom.rows_per_cta(o)
    if quant == "int8":
        tag, smem = "splitnn_bottom_int8_gather", bottom.int8_smem_bytes(
            d, o, rows, True, True)
    else:
        tag, smem = "splitnn_bottom_gather", bottom.f32_smem_bytes(
            d, o, rows, True, False)
    return BlockReport(tag, _shape(M=m, N=n, d=d, o=o, B=b, rows=rows),
                       smem, bottom.SMEM_CAP,
                       note="gathered rows read from global memory",
                       params=dict(m=m, n=n, d=d, o=o, b=b, quant=quant))


def kmeans_update_blocks(n: int, d: int, k: int, m: int = 1
                         ) -> BlockReport:
    """K3: a CTA's tiles, centroids and partial sums at the tile
    ``geometry`` picks."""
    geo = update.geometry(m, n, k, d)
    return BlockReport("kmeans_update",
                       _shape(M=m, N=n, d=d, K=k, tile=geo.tile),
                       geo.smem_bytes, SMEM_LIMIT,
                       params=dict(m=m, n=n, d=d, k=k))


def kmeans_update_gather_blocks(n: int, d: int, k: int, b: int,
                                m: int = 1) -> BlockReport:
    """K4: K3's geometry for the B gathered rows; N does not enter."""
    geo = update.geometry(m, b, k, d)
    return BlockReport("kmeans_update_gather",
                       _shape(M=m, N=n, d=d, K=k, B=b, tile=geo.tile),
                       geo.smem_bytes, SMEM_LIMIT,
                       note="gathered rows read from global memory",
                       params=dict(m=m, n=n, d=d, k=k, b=b))


def kmeans_assign_blocks(n: int, d: int, k: int, m: int = 1
                         ) -> BlockReport:
    """K5: a CTA's tile, centroids and norms at its ``geometry``."""
    geo = assign.geometry(m, n, k, d)
    return BlockReport("kmeans_assign",
                       _shape(M=m, N=n, d=d, K=k, tile=geo.tile),
                       geo.smem_bytes, SMEM_LIMIT,
                       params=dict(m=m, n=n, d=d, k=k))


def psi_prf_blocks(p: int, rows: int = 2) -> BlockReport:
    """K6: one id a thread, no shared memory."""
    return BlockReport("psi_prf", _shape(rows=rows, P=p), prf.smem_bytes(),
                       SMEM_LIMIT, params=dict(rows=rows, p=p))


def sorted_intersect_blocks(p: int, pairs: int = 1) -> BlockReport:
    """K7 (K8 past ``SINGLE_PASS_MAX_P``): one merge-path tile a CTA, at
    the CTA size ``merge_geometry`` picks; P does not bound it."""
    geo = merge.merge_geometry(pairs, p)
    tiled = p > merge.SINGLE_PASS_MAX_P
    return BlockReport("sorted_intersect_tiled" if tiled
                       else "sorted_intersect",
                       _shape(pairs=pairs, P=p, threads=geo.threads),
                       geo.smem_bytes, SMEM_LIMIT,
                       note="K8's counterpart: the same kernel" if tiled
                       else "", params=dict(pairs=pairs, p=p))


def _dtype_name(dtype: torch.dtype) -> str:
    return "bf16" if dtype == torch.bfloat16 else "f32"


def flash_attention_blocks(dh: int, dtype: torch.dtype) -> BlockReport:
    """K11's forward at head dim ``dh``: static K/V tiles (f32) or the
    bf16 instance's dynamic Q and double-buffered K/V tiles."""
    return BlockReport("flash_attention",
                       _shape(Dh=dh, dtype=_dtype_name(dtype)),
                       fa.smem_bytes(dh, dtype), SMEM_LIMIT,
                       note="static" if dtype == torch.float32
                       else "dynamic",
                       params=dict(dh=dh, dtype=_dtype_name(dtype)))


def flash_attention_bwd_blocks(dh: int, dtype: torch.dtype) -> BlockReport:
    """K11's backward at head dim ``dh``: the larger of its dq and dk/dv
    CTAs."""
    dq, dkdv = fa.bwd_smem_bytes(dh, dtype)
    return BlockReport("flash_attention_bwd",
                       _shape(Dh=dh, dtype=_dtype_name(dtype)),
                       max(dq, dkdv), SMEM_LIMIT,
                       note=f"dq {dq}, dk/dv {dkdv}",
                       params=dict(dh=dh, dtype=_dtype_name(dtype)))


def ssd_scan_blocks(arch: str, h: int, p: int, n: int, chunk: int,
                    s: int) -> BlockReport:
    """K12 at a prefill's (H, P, N, L): the larger of its C Bᵀ and chunk
    CTAs."""
    cb, chunk_cta = ssd.smem_bytes(p, n, chunk)
    return BlockReport("ssd_scan", _shape(arch=arch, S=s, H=h, P=p, N=n,
                                          L=chunk),
                       max(cb, chunk_cta), SMEM_LIMIT,
                       note=f"C Bᵀ {cb}, chunk {chunk_cta}",
                       params=dict(s=s, h=h, p=p, n=n, chunk=chunk))


def _ssd_prefill(arch: str, s: int = 2048) -> BlockReport:
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    ssm = cfg.ssm
    return ssd_scan_blocks(arch, ssm.expand * cfg.d_model // ssm.head_dim,
                           ssm.head_dim, ssm.state_dim, ssm.chunk, s)


def smem_report() -> List[BlockReport]:
    """The default matrix: the reference's rows (``vmem_report``) at its
    shapes (the SplitNN rows at the engines' bottom width, module
    docstring), K5, K11's forward and backward at Dh 64/128/160/256 in
    both dtypes, and K12 at mamba2-1.3b's and hymba-1.5b's prefill."""
    budget_rows = GATHER_VMEM_BUDGET // (F32 * 128)   # N at d = 128
    i8_rows = GATHER_VMEM_BUDGET // 128               # 4x the f32 reach
    reports = [
        splitnn_bottom_blocks(512, 128, 8),
        splitnn_bottom_blocks(4096, 512, 8),
        splitnn_bottom_blocks(4096, 128, 8, quant="int8"),
        splitnn_bottom_gather_blocks(budget_rows, 128, 8, 512),
        splitnn_bottom_gather_blocks(budget_rows + 1, 128, 8, 512),
        splitnn_bottom_gather_blocks(i8_rows, 128, 8, 512, quant="int8"),
        splitnn_bottom_gather_blocks(i8_rows + 1, 128, 8, 512,
                                     quant="int8"),
        kmeans_update_blocks(1 << 20, 16, 10),
        kmeans_update_gather_blocks(budget_rows, 16, 10, 1024),
        kmeans_update_gather_blocks(4 * budget_rows, 16, 10, 1024),
        kmeans_assign_blocks(1 << 20, 16, 10),
        psi_prf_blocks(1 << 20),
        sorted_intersect_blocks(merge.SINGLE_PASS_MAX_P),
        sorted_intersect_blocks(1 << 19),
        sorted_intersect_blocks(1 << 21),
    ]
    for dtype in (torch.float32, torch.bfloat16):
        for dh in (64, 128, 160, 256):
            reports.append(flash_attention_blocks(dh, dtype))
            reports.append(flash_attention_bwd_blocks(dh, dtype))
    reports += [_ssd_prefill("mamba2-1.3b"), _ssd_prefill("hymba-1.5b")]
    return reports
