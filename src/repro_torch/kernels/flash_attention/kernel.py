"""Wrappers of the CUDA flash attention kernel K11
(``csrc/flash_attention.cu``), the port of ``repro/kernels/
flash_attention/kernel.py::flash_attention_pallas``, and of its backward
(``csrc/flash_attention_bwd.cu``, which the reference does not have: it
differentiates its full attention with XLA).  The tensors come in the
framework layout, unpadded; the kernels fold the GQA groups and mask
their own edges.  Forward: bf16 on the tensor cores (``mma.sync`` tiles,
p carried in three bf16 pieces), f32 on the CUDA cores; asked for it, it
also writes the row log-sum-exp (base e) that the backward reads.
Backward: D = rowsum(do·o) and dq, then dk/dv, p = exp(s - lse) from the
forward's LSE; bf16 with all five products on the tensor cores (p and
ds in three bf16 pieces), f32 on the CUDA cores; deterministic (no
atomics).

These are the raw launches: ``ops.flash_attention`` is the
differentiable op (an autograd ``Function`` over the two).  The forward
launch records no graph, so under grad mode it refuses an operand that
requires grad rather than silently cut the graph."""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple, Union

import torch

from repro_torch.kernels import build

#: the kernels' limits: the forward's f32 instance holds all G = H / KV
#: query heads of a kv head in one CTA (at most 128 threads); both pad Dh
#: up to 256
MAX_GROUP = 128
MAX_HEAD_DIM = 256
_DTYPES = (torch.float32, torch.bfloat16)


def _check(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
           ) -> None:
    """The operand checks both directions share."""
    build.require_cuda(name, q, k, v, dtype=q.dtype)
    if q.dtype not in _DTYPES:
        raise ValueError(f"{name}: expected f32 or bf16, got {q.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{name}: expected q (B,Sq,H,Dh), k/v "
                         f"(B,Sk,KV,Dh), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, dh = q.shape
    kvh = k.shape[2]
    if k.shape[0] != b or k.shape[3] != dh or kvh == 0 or h % kvh:
        raise ValueError(f"{name}: k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if h // kvh > MAX_GROUP or dh > MAX_HEAD_DIM:
        raise ValueError(f"{name}: G = {h // kvh} query heads a kv head "
                         f"(max {MAX_GROUP}) or Dh = {dh} (max "
                         f"{MAX_HEAD_DIM}) out of the kernel's range")


class BwdTiles(NamedTuple):
    """The bf16 backward's tiles for a head dim (``flash_attention_bwd.cu``,
    ``BwdShape``): Dh padded to ``dp``; the dq kernel's CTA holds 64
    (query row, head) pairs and walks key tiles of ``bk``; a dk/dv CTA
    holds ``bn`` keys, 16 a warp, ``dsplit`` warps sharing 16 keys (each
    a ``dp / dsplit`` slice of the head dims), and walks query tiles of
    ``bm`` rows, heads first.  ``passes``: the bf16 tensor-core passes of
    2·B·H·Dh·(visible pairs) the two kernels run (S and dP in both, each
    warp of a shared slab forming its own; dQ, dK, dV three each)."""
    dp: int
    bk: int
    bn: int
    bm: int
    dsplit: int
    passes: int


def bwd_tiles(dh: int) -> BwdTiles:
    dp = next(d for d in (32, 64, 128, 160, 256) if dh <= d)
    dsplit = 1 if dp <= 128 else 2
    return BwdTiles(dp=dp, bk=64 if dp <= 128 else 32, bn=64 // dsplit,
                    bm=64 if dp <= 64 else 32, dsplit=dsplit,
                    passes=2 + 2 * dsplit + 9)


def _dp(dh: int, ladder: Tuple[int, ...]) -> int:
    return next(d for d in ladder if dh <= d)


def smem_bytes(dh: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """Shared memory of one forward CTA at head dim ``dh``, as
    ``flash_attention.cu`` lays it out.  f32 (``flash_attention_kernel``,
    static ``__shared__``): K and V tiles of ``TILE_FLOATS`` = 4,096
    floats each, whatever DP.  bf16 (``flash_attention_kernel_bf16_mma``,
    dynamic, ``TcShape::SMEM``): Q's 64 rows and two buffers each of K
    and V tiles of BK keys (64 up to DP 128, else 32), rows of DP + 8
    bf16."""
    if dtype == torch.float32:
        return 2 * 4096 * 4
    dp = _dp(dh, (32, 64, 128, 160, 256))
    bk = 64 if dp <= 128 else 32
    return (64 + 4 * bk) * (dp + 8) * 2


def bwd_smem_bytes(dh: int, dtype: torch.dtype = torch.bfloat16
                   ) -> Tuple[int, int]:
    """Shared memory of one CTA of the backward's dq and dk/dv kernels at
    head dim ``dh`` (all dynamic), as ``flash_attention_bwd.cu`` lays it
    out.  f32 (``Tiles``): BM query rows and BN keys staged at a stride
    of DP + 1 floats (q, do, k, v), p (and ds) at BN + 1, and the dk/dv
    kernel's two row statistics.  bf16 (``BwdShape``, ``bwd_tiles``):
    the dq CTA's 64 q and do rows and two buffers each of k and v tiles
    of ``bk`` keys, rows of DP + 8 bf16, plus two f32 row statistics;
    the dk/dv CTA's ``bn`` k and v rows and two buffers each of q and do
    tiles of ``bm`` rows, plus four f32 per query row.  The bf16 sum
    kernel takes none."""
    dp = _dp(dh, (32, 64, 128, 160, 256))
    if dtype == torch.float32:
        bm = 64 if dp <= 160 else 32
        bn = 64 if dp <= 128 else 32
        staged = (2 * bm + 2 * bn) * (dp + 1)
        return (4 * (staged + bm * (bn + 1)),
                4 * (staged + 2 * bm * (bn + 1) + 2 * bm))
    t = bwd_tiles(dh)
    ld = t.dp + 8
    return ((2 * 64 + 4 * t.bk) * ld * 2 + 2 * 64 * 4,
            (2 * t.bn + 4 * t.bm) * ld * 2 + 4 * t.bm * 4)


#: the dk/dv CTAs the bf16 backward aims at: the heads of a kv head are
#: split over up to G CTAs (each its own chunk, summed in order by a third
#: kernel) until there are about this many, so the longest causal key
#: tiles do not set the launch's time alone (four to five waves of 2 CTAs
#: on 132 SMs)
BWD_CTAS = 1024


def bwd_heads_a_cta(b: int, sk: int, kvh: int, g: int, dh: int) -> int:
    """The query heads a dk/dv CTA of the bf16 backward takes: all G
    where (batch, kv head, key tile) units alone reach ``BWD_CTAS``, else
    G split into chunks of this many (the last may be shorter)."""
    units = -(-sk // bwd_tiles(dh).bn) * kvh * b
    chunks = min(g, -(-BWD_CTAS // units))
    return -(-g // chunks)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         prefix: int = 0, logit_cap: float = 0.0,
                         return_lse: bool = False
                         ) -> Union[torch.Tensor,
                                    Tuple[torch.Tensor, torch.Tensor]]:
    """K11: q (B,Sq,H,Dh), k/v (B,Sk,KV,Dh), all f32 or all bf16, on one
    CUDA device -> (B,Sq,H,Dh) in q's dtype, f32 math inside; with
    ``return_lse``, also the f32 (B,H,Sq) row log-sum-exp of the masked
    scores in base e (the backward's statistics).  The output's bits do
    not depend on ``return_lse``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention_cuda: an operand requires grad "
                           "and this launch records no graph; "
                           "ops.flash_attention differentiates through "
                           "K11's backward")
    _check("flash_attention", q, k, v)
    b, sq, h, dh = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    fn = build.function("flash_attention", "flash_attention_launch", 5, 10,
                        2)
    err = build.launch(fn, q.device,
                       q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       out.data_ptr(), None if lse is None else lse.data_ptr(),
                       b, sq, sk, h, kvh, dh, int(causal), int(window),
                       int(prefix), int(q.dtype == torch.bfloat16),
                       1.0 / math.sqrt(dh), float(logit_cap))
    build.check(err, "flash_attention")
    build.LAUNCHES["flash_attention"] += 1
    return (out, lse) if return_lse else out


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             do: torch.Tensor, lse: torch.Tensor, *,
                             causal: bool = True, window: int = 0,
                             prefix: int = 0, logit_cap: float = 0.0
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """K11's backward: q/o/do (B,Sq,H,Dh), k/v (B,Sk,KV,Dh), all of one
    dtype (f32 or bf16) on one CUDA device, o the forward's output, do
    its gradient and lse the forward's f32 (B,H,Sq) row log-sum-exp
    (``flash_attention_cuda(..., return_lse=True)``) -> (dq, dk, dv) in
    that dtype, f32 math inside.  A causal call with Sq > Sk (query rows
    that see no key) is refused."""
    _check("flash_attention_bwd", q, k, v)
    build.require_cuda("flash_attention_bwd", q, o, do, dtype=q.dtype)
    build.require_cuda("flash_attention_bwd", q, lse)
    if lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: lse must be f32, got "
                         f"{lse.dtype}")
    b, sq, h, dh = q.shape
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)} and do "
                         f"{tuple(do.shape)} must have q's shape "
                         f"{tuple(q.shape)}")
    if lse.shape != (b, h, sq):
        raise ValueError(f"flash_attention_bwd: lse {tuple(lse.shape)} must "
                         f"be (B, H, Sq) = {(b, h, sq)}")
    sk, kvh = k.shape[1], k.shape[2]
    if causal and sq > sk:
        raise ValueError(f"flash_attention_bwd: causal with Sq = {sq} > Sk "
                         f"= {sk} leaves query rows that see no key")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    d_row = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    bf16 = q.dtype == torch.bfloat16
    g = h // kvh
    hs = bwd_heads_a_cta(b, sk, kvh, g, dh) if bf16 else g
    chunks = -(-g // hs)
    part = (torch.empty((chunks, 2, k.numel()), dtype=torch.float32,
                        device=q.device) if chunks > 1 else None)
    fn = build.function("flash_attention_bwd", "flash_attention_bwd_launch",
                        11, 11, 2)
    err = build.launch(fn, q.device,
                       q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       o.data_ptr(), do.data_ptr(), lse.data_ptr(),
                       dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                       d_row.data_ptr(),
                       None if part is None else part.data_ptr(), b, sq, sk,
                       h, kvh, dh, hs, int(causal), int(window), int(prefix),
                       int(bf16), 1.0 / math.sqrt(dh), float(logit_cap))
    build.check(err, "flash_attention_bwd")
    build.LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv
