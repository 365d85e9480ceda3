"""Plain PyTorch version of the flash attention kernel (K11): the port's
``full_attention`` with suffix-aligned positions, as
``repro/kernels/flash_attention/ref.py``, computed in f32 and cast back
to q's dtype, as the kernel (and the reference's ``ops.py``) do."""
from __future__ import annotations

import torch

from repro_torch.models.attention import full_attention


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, prefix: int = 0,
                    logit_cap: float = 0.0) -> torch.Tensor:
    """q (B,Sq,H,Dh), k/v (B,Sk,KV,Dh) -> (B,Sq,H,Dh) in q's dtype."""
    sq, sk = q.shape[1], k.shape[1]
    q_pos = torch.arange(sq, dtype=torch.int32, device=q.device) + (sk - sq)
    k_pos = torch.arange(sk, dtype=torch.int32, device=q.device)
    out = full_attention(q.float(), k.float(), v.float(), q_pos=q_pos,
                         k_pos=k_pos, causal=causal, window=window,
                         prefix=prefix, logit_cap=logit_cap)
    return out.to(q.dtype)
