"""Wrapper of the CUDA flash attention kernel K11
(``csrc/flash_attention.cu``), the port of ``repro/kernels/
flash_attention/kernel.py::flash_attention_pallas``.  The tensors come in
the framework layout, unpadded; the kernel folds the GQA groups and
masks its own edges.  bf16 runs on the tensor cores (``mma.sync`` tiles,
p carried in three bf16 pieces), f32 on the CUDA cores.  Forward only:
under grad mode an operand that requires grad is refused."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build

#: the kernel's limits: the f32 instance holds all G = H / KV query heads
#: of a kv head in one CTA (at most 128 threads); both pad Dh up to 256
MAX_GROUP = 128
MAX_HEAD_DIM = 256
_DTYPES = (torch.float32, torch.bfloat16)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         prefix: int = 0, logit_cap: float = 0.0
                         ) -> torch.Tensor:
    """K11: q (B,Sq,H,Dh), k/v (B,Sk,KV,Dh), all f32 or all bf16, on one
    CUDA device -> (B,Sq,H,Dh) in q's dtype, f32 math inside."""
    build.refuse_grad("flash_attention", q, k, v)
    build.require_cuda("flash_attention", q, k, v, dtype=q.dtype)
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention: expected f32 or bf16, got "
                         f"{q.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: expected q (B,Sq,H,Dh), k/v "
                         f"(B,Sk,KV,Dh), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, dh = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != dh or kvh == 0 or h % kvh:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if h // kvh > MAX_GROUP or dh > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: G = {h // kvh} query heads a kv "
                         f"head (max {MAX_GROUP}) or Dh = {dh} (max "
                         f"{MAX_HEAD_DIM}) out of the kernel's range")
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
