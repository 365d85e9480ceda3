"""Wrappers of the CUDA flash attention kernel K11
(``csrc/flash_attention.cu``), the port of ``repro/kernels/
flash_attention/kernel.py::flash_attention_pallas``, and of its backward
(``csrc/flash_attention_bwd.cu``, which the reference does not have: it
differentiates its full attention with XLA).  The tensors come in the
framework layout, unpadded; the kernels fold the GQA groups and mask
their own edges.  Forward: bf16 on the tensor cores (``mma.sync`` tiles,
p carried in three bf16 pieces), f32 on the CUDA cores.  Backward: the
row statistics recomputed, then dq, then dk/dv, f32 products on the CUDA
cores for both dtypes, deterministic (no atomics).

These are the raw launches: ``ops.flash_attention`` is the
differentiable op (an autograd ``Function`` over the two).  The forward
launch records no graph, so under grad mode it refuses an operand that
requires grad rather than silently cut the graph."""
from __future__ import annotations

import math
from typing import Tuple

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


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         prefix: int = 0, logit_cap: float = 0.0
                         ) -> torch.Tensor:
    """K11: q (B,Sq,H,Dh), k/v (B,Sk,KV,Dh), all f32 or all bf16, on one
    CUDA device -> (B,Sq,H,Dh) in q's dtype, f32 math inside."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention_cuda: an operand requires grad "
                           "and this launch records no graph; "
                           "ops.flash_attention differentiates through "
                           "K11's backward")
    _check("flash_attention", q, k, v)
    b, sq, h, dh = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    fn = build.function("flash_attention", "flash_attention_launch", 4, 10,
                        2)
    err = build.launch(fn, q.device,
                       q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       out.data_ptr(), b, sq, sk, h, kvh, dh, int(causal),
                       int(window), int(prefix),
                       int(q.dtype == torch.bfloat16), 1.0 / math.sqrt(dh),
                       float(logit_cap))
    build.check(err, "flash_attention")
    build.LAUNCHES["flash_attention"] += 1
    return out


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             do: torch.Tensor, *, causal: bool = True,
                             window: int = 0, prefix: int = 0,
                             logit_cap: float = 0.0
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """K11's backward: q/o/do (B,Sq,H,Dh), k/v (B,Sk,KV,Dh), all of one
    dtype (f32 or bf16) on one CUDA device, o the forward's output and do
    its gradient -> (dq, dk, dv) in that dtype, f32 math inside.  A
    causal call with Sq > Sk (query rows that see no key) is refused."""
    _check("flash_attention_bwd", q, k, v)
    build.require_cuda("flash_attention_bwd", q, o, do, dtype=q.dtype)
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)} and do "
                         f"{tuple(do.shape)} must have q's shape "
                         f"{tuple(q.shape)}")
    b, sq, h, dh = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if causal and sq > sk:
        raise ValueError(f"flash_attention_bwd: causal with Sq = {sq} > Sk "
                         f"= {sk} leaves query rows that see no key")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    stats = torch.empty((b, h, sq, 3), dtype=torch.float32, device=q.device)
    fn = build.function("flash_attention_bwd", "flash_attention_bwd_launch",
                        9, 10, 2)
    err = build.launch(fn, q.device,
                       q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       o.data_ptr(), do.data_ptr(), dq.data_ptr(),
                       dk.data_ptr(), dv.data_ptr(), stats.data_ptr(), b, sq,
                       sk, h, kvh, dh, int(causal), int(window), int(prefix),
                       int(q.dtype == torch.bfloat16), 1.0 / math.sqrt(dh),
                       float(logit_cap))
    build.check(err, "flash_attention_bwd")
    build.LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv
