"""Plain PyTorch versions of the flash attention kernel (K11) and of its
backward.

``flash_attention`` is the port's ``full_attention`` with suffix-aligned
positions, as ``repro/kernels/flash_attention/ref.py``, computed in f32
and cast back to q's dtype, as the kernel (and the reference's
``ops.py``) do; with ``return_lse`` also the row log-sum-exp of the
masked f32 scores in base e (B, H, Sq), what the kernel's forward
writes for its backward.

``flash_attention_bwd`` is the plain version of K11's backward kernel
(``csrc/flash_attention_bwd.cu``), step by step in f32: the row
statistics recomputed from q and k (the row max m and l = Σ exp(s - m);
the kernel reads the forward's LSE instead, so this stays an independent
oracle),
``D = rowsum(do·o)``, then ``p = exp(s - m) / l``, ``dp = do·vᵀ``,
``ds = p∘(dp - D)`` times the softcap's slope ``1 - tanh²(s/cap)``, zero
where the mask hides the pair, and dq = scale·ds·k, dk = scale·dsᵀ·q,
dv = pᵀ·do, dk and dv summed over the G query heads of each kv head.
The reference has no backward kernel: it differentiates its full
attention with XLA, which this equals (tests/test_torch_flash_attention.py).
"""
from __future__ import annotations

from typing import Tuple, Union

import torch

from repro_torch.models.attention import NEG_INF, _mask, full_attention


def _positions(sq: int, sk: int, device):
    q_pos = torch.arange(sq, dtype=torch.int32, device=device) + (sk - sq)
    k_pos = torch.arange(sk, dtype=torch.int32, device=device)
    return q_pos, k_pos


def _scores(q, k, *, causal, window, prefix, logit_cap):
    """The masked f32 scores (B,KV,G,Sq,Sk) of q (B,Sq,H,Dh), k
    (B,Sk,KV,Dh), the softcap slope's t = tanh(raw / cap) (None without a
    cap) and the mask."""
    b, sq, h, dh = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    qf = q.float().reshape(b, sq, kvh, h // kvh, dh)
    raw = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()) * dh ** -0.5
    t = torch.tanh(raw / logit_cap) if logit_cap else None
    s = t * logit_cap if logit_cap else raw
    q_pos, k_pos = _positions(sq, sk, q.device)
    mask = _mask(q_pos, k_pos, causal=causal, window=window, prefix=prefix)
    return s.masked_fill(~mask, NEG_INF), t, mask


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, prefix: int = 0,
                    logit_cap: float = 0.0, return_lse: bool = False
                    ) -> Union[torch.Tensor, Tuple[torch.Tensor,
                                                   torch.Tensor]]:
    """q (B,Sq,H,Dh), k/v (B,Sk,KV,Dh) -> (B,Sq,H,Dh) in q's dtype; with
    ``return_lse`` also the f32 (B,H,Sq) ``logsumexp`` of the masked
    scores."""
    q_pos, k_pos = _positions(q.shape[1], k.shape[1], q.device)
    out = full_attention(q.float(), k.float(), v.float(), q_pos=q_pos,
                         k_pos=k_pos, causal=causal, window=window,
                         prefix=prefix, logit_cap=logit_cap).to(q.dtype)
    if not return_lse:
        return out
    s, _, _ = _scores(q, k, causal=causal, window=window, prefix=prefix,
                      logit_cap=logit_cap)
    b, sq, h, _ = q.shape
    return out, torch.logsumexp(s, -1).reshape(b, h, sq)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        prefix: int = 0, logit_cap: float = 0.0
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q/o/do (B,Sq,H,Dh), k/v (B,Sk,KV,Dh), o the forward's output and do
    its gradient -> (dq, dk, dv) in the operands' dtypes, f32 math."""
    b, sq, h, dh = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = dh ** -0.5
    qf = q.float().reshape(b, sq, kvh, g, dh)
    kf, vf = k.float(), v.float()
    dof = do.float().reshape(b, sq, kvh, g, dh)
    s, t, mask = _scores(q, k, causal=causal, window=window, prefix=prefix,
                         logit_cap=logit_cap)
    m = s.amax(-1, keepdim=True)                       # (B,KV,G,Sq,1)
    e = torch.exp(s - m)
    p = e / e.sum(-1, keepdim=True)
    d_row = (do.float() * o.float()).sum(-1)            # (B,Sq,H)
    d_row = d_row.reshape(b, sq, kvh, g).permute(0, 2, 3, 1)[..., None]
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dof)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dof, vf)
    ds = p * (dp - d_row)
    if logit_cap:
        ds = ds * (1.0 - t * t)
    ds = ds.masked_fill(~mask, 0.0)
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, kf) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qf) * scale
    return (dq.reshape(b, sq, h, dh).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
