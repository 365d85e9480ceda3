"""GQA attention: full / chunked (online softmax) / flash / decode with a
KV cache (the port of ``repro/models/attention.py``).

Supports sliding windows (ring-buffer caches), always-visible prefixes,
attention logit softcapping and optional rotary.  ``attend`` picks the
algorithm: on a CUDA tensor the default is K11, the hand-written flash
kernel (``kernels/flash_attention``); on the CPU it is the reference's
rule (full below 8,192 tokens, chunked above).  ``use_form(form)``
fixes the form the layers' calls take inside it (the reference's
``attn_impl``, which its model code passes down; the dry run counts its
FLOPs in the ``"full"`` form).  Masked scores take the
finite ``NEG_INF``, as the reference, so a row whose first visible k
block is fully masked stays finite.

Caches are updated in place (``cache_update``/``cache_fill`` write into
the tensors of the dict they are given and return it): the reference
returns new arrays, and in place saves a copy of every layer's cache a
decode step.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

from repro_torch import sharding
from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import dense_init, rotary_embed, softcap

__all__ = ["NEG_INF", "init_attention", "local_heads", "project",
           "qkv_project",
           "out_project", "full_attention", "chunked_attention", "attend",
           "use_form", "layer_attention", "context_attention",
           "init_cache", "cache_slot", "cache_update", "cache_fill",
           "decode_attention"]

NEG_INF = -1e30

_FORM: Optional[str] = None     # use_form's, None: attend's own rule


def init_attention(gen: torch.Generator, cfg: ArchConfig, dtype):
    """q/k/v/o projections of one attention layer of ``cfg`` (biases on
    q/k/v where ``cfg.qkv_bias``)."""
    d, h, kv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    dh = cfg.resolved_head_dim
    p = {"wq": dense_init(gen, d, (h, dh), dtype),
         "wk": dense_init(gen, d, (kv, dh), dtype),
         "wv": dense_init(gen, d, (kv, dh), dtype),
         "wo": dense_init(gen, h * dh, d, dtype)}
    if cfg.qkv_bias:
        for name, heads in (("bq", h), ("bk", kv), ("bv", kv)):
            p[name] = torch.zeros((heads, dh), dtype=dtype,
                                  device=gen.device)
    return p


def local_heads(params, cfg: ArchConfig, axis):
    """A tensor-parallel rank's attention params: ``params`` holds its
    block of the q heads (``wq`` (D, H/m, Dh), ``wo`` (H/m·Dh, D)) and
    either its block of the kv heads, where they divide ``model``, or all
    of them.  Returns the params the rank's heads read: the biases' rows
    of its heads and, for whole kv heads, those its q heads use (GQA:
    q head h reads kv head h // (H/KV)), each through ``copy_to_model``
    (one collective for all of them in the backward), since every rank
    uses such a replicated param in part."""
    h, kv = cfg.n_heads, cfg.n_kv_heads
    hl = params["wq"].shape[1]
    q0, g = axis.rank * hl, h // kv
    kvl = params["wk"].shape[1]
    names = ("bq", "bk", "bv") + (("wk", "wv") if kvl == kv else ())
    rep = sharding.copy_params_to_model(
        {n: params[n] for n in names if n in params}, axis)
    out = dict(params)
    if "bq" in rep:
        out["bq"] = rep["bq"][q0:q0 + hl]
    if kvl != kv:                 # kv heads sharded with the q heads
        k0 = axis.rank * kvl
        for name in ("bk", "bv"):
            if name in rep:
                out[name] = rep[name][k0:k0 + kvl]
        return out
    if hl % g == 0:               # whole groups: their kv heads
        idx = slice(q0 // g, q0 // g + hl // g)
    elif g % hl == 0:             # part of one group: its kv head
        idx = slice(q0 // g, q0 // g + 1)
    else:                         # one kv head for each q head
        idx = torch.arange(q0, q0 + hl, device=params["wk"].device) // g
    for name in ("wk", "wv"):
        out[name] = rep[name][:, idx]
    for name in ("bk", "bv"):
        if name in rep:
            out[name] = rep[name][idx]
    return out


def project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B,S,D) @ w (D,H,Dh) -> (B,S,H,Dh) in x's dtype."""
    d, h, dh = w.shape
    return (x @ w.to(x.dtype).reshape(d, h * dh)).unflatten(-1, (h, dh))


def qkv_project(params, x: torch.Tensor, kv_x: Optional[torch.Tensor] = None):
    """x: (B,S,D) -> q (B,S,H,Dh), k/v (B,Skv,KV,Dh)."""
    kv_x = x if kv_x is None else kv_x
    q = project(x, params["wq"])
    k = project(kv_x, params["wk"])
    v = project(kv_x, params["wv"])
    if "bq" in params:
        q = q + params["bq"].to(x.dtype)
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    return q, k, v


def out_project(params, attn_out: torch.Tensor) -> torch.Tensor:
    """attn_out: (B,S,H,Dh) -> (B,S,D)."""
    b, s, h, dh = attn_out.shape
    return attn_out.reshape(b, s, h * dh) @ params["wo"].to(attn_out.dtype)


def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
          window: int, prefix: int) -> torch.Tensor:
    """q_pos: (Sq,), k_pos: (Sk,) -> bool (Sq, Sk) of visible entries;
    window == 0 means full attention."""
    qp = q_pos[:, None]
    kp = k_pos[None, :]
    ok = kp >= 0
    if causal:
        ok = ok & (kp <= qp)
    eff = window if window > 0 else 2 ** 30
    return ok & (((qp - kp) < eff) | (kp < prefix))


def _gqa_scores(q: torch.Tensor, k: torch.Tensor, scale: float, cap: float
                ) -> torch.Tensor:
    """q: (B,Sq,KV,G,Dh), k: (B,Sk,KV,Dh) -> (B,KV,G,Sq,Sk) f32."""
    s = torch.einsum("bqkgd,bskd->bkgqs", q, k).float() * scale
    return softcap(s, cap)


def full_attention(q, k, v, *, q_pos, k_pos, causal=True, window=0,
                   prefix=0, logit_cap=0.0) -> torch.Tensor:
    """Naive O(S²) attention. q: (B,Sq,H,Dh), k/v: (B,Sk,KV,Dh)."""
    b, sq, h, dh = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, sq, kv, h // kv, dh)
    scores = _gqa_scores(qg, k, dh ** -0.5, logit_cap)    # (B,KV,G,Sq,Sk)
    mask = _mask(q_pos, k_pos, causal=causal, window=window, prefix=prefix)
    scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(v.dtype), v)
    return out.reshape(b, sq, h, dh)


def _divisor_block(block: int, n: int) -> int:
    """Shrink ``block`` by halving to a divisor of ``n`` (ragged lengths)."""
    block = min(block, n)
    while n % block:
        block //= 2
    return max(block, 1)


def chunked_attention(q, k, v, *, q_pos, k_pos, causal=True, window=0,
                      prefix=0, logit_cap=0.0, q_block=512, k_block=1024
                      ) -> torch.Tensor:
    """Online-softmax blocked attention; peak memory O(q_block × k_block).
    Same math as ``full_attention``, the reference's default at >= 8,192
    tokens."""
    b, sq, h, dh = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = dh ** -0.5
    q_block = _divisor_block(q_block, sq)
    k_block = _divisor_block(k_block, sk)
    qg = q.reshape(b, sq, kvh, g, dh)
    outs = []
    for q0 in range(0, sq, q_block):
        qi, qp = qg[:, q0:q0 + q_block], q_pos[q0:q0 + q_block]
        m = torch.full((b, kvh, g, q_block), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, kvh, g, q_block, dh), dtype=torch.float32,
                          device=q.device)
        for k0 in range(0, sk, k_block):
            ki, vi = k[:, k0:k0 + k_block], v[:, k0:k0 + k_block]
            s = _gqa_scores(qi, ki, scale, logit_cap)
            msk = _mask(qp, k_pos[k0:k0 + k_block], causal=causal,
                        window=window, prefix=prefix)
            s = s.masked_fill(~msk, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            pv = torch.einsum("bkgqs,bskd->bkgqd", p.to(vi.dtype), vi)
            acc = acc * corr[..., None] + pv.float()
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4))             # (B,qb,KV,G,Dh)
    return torch.cat(outs, 1).reshape(b, sq, h, dh).to(q.dtype)


def attend(q, k, v, *, q_pos, k_pos, causal=True, window=0, prefix=0,
           logit_cap=0.0, impl: Optional[str] = None,
           kernel_impl: Optional[str] = None) -> torch.Tensor:
    """Attention by ``impl``: ``"full"``, ``"chunked"``, ``"flash"`` (K11,
    which assumes suffix-aligned contiguous positions, as every call
    site has) or ``None``/``"auto"``: K11 on a CUDA tensor, the
    reference's full/chunked rule on the CPU.  ``kernel_impl`` reaches
    K11's op: ``"ref"`` asks for its plain version on the card."""
    if impl in (None, "auto"):
        impl = _FORM
    if impl in (None, "auto"):
        if q.device.type == "cuda":
            impl = "flash"
        else:
            impl = ("chunked" if (q.shape[1] >= 8192 or k.shape[1] >= 8192)
                    else "full")
    if impl == "flash":
        from repro_torch.kernels.flash_attention import ops as fa_ops
        return fa_ops.flash_attention(
            q, k, v, causal=causal, window=int(window), prefix=int(prefix),
            logit_cap=float(logit_cap), impl=kernel_impl)
    fn = {"full": full_attention, "chunked": chunked_attention}[impl]
    return fn(q, k, v, q_pos=q_pos, k_pos=k_pos, causal=causal,
              window=window, prefix=prefix, logit_cap=logit_cap)


@contextlib.contextmanager
def use_form(form: Optional[str]):
    """Inside it, ``attend`` called with no form computes ``form``
    (``"full"``, ``"chunked"``, ``"flash"``; ``None``/``"auto"``:
    its own rule); on exit the form before it holds again."""
    global _FORM
    if form not in (None, "auto", "full", "chunked", "flash"):
        raise ValueError(f"unknown attention form {form!r}")
    outer, _FORM = _FORM, form
    try:
        yield
    finally:
        _FORM = outer


# ------------------------------------------------------ under a mesh

def layer_attention(params, x, cfg: ArchConfig, *, positions, causal=True,
                    window: int = 0, prefix: int = 0, rope: bool = False,
                    kv_x=None, kv_positions=None, impl: Optional[str] = None):
    """A layer's attention with its output projection: self-attention
    of x (B,S,D), or cross-attention against ``kv_x`` (B,Skv,D) at
    ``kv_positions``, rotary on q and k where ``rope``.  Returns (y
    (B,S,D), k, v).  Under the active layout (``sharding.lm_layout``)
    by its ``attention_route`` over x's S positions:

    - ``"tp"``, tensor parallel (``params`` holds the rank's q heads):
      x and ``kv_x`` through ``copy_to_model``, the rank's heads
      (``local_heads``, its K11 launch on them), ``wo`` row-parallel
      and summed over ``model``;
    - ``"cp"``, context parallel (the whole params):
      ``context_attention``;
    - else the whole attention, replicated over ``model``."""
    lay = sharding.lm_layout(cfg)
    route, axis = (None, None) if lay is None else \
        lay.attention_route(x.shape[1])
    if route == "cp":
        return context_attention(
            params, x, cfg, axis, positions=positions, causal=causal,
            window=window, prefix=prefix, rope=rope, kv_x=kv_x,
            kv_positions=kv_positions, impl=impl)
    tp = axis if route == "tp" else None
    if tp is not None:
        x = sharding.copy_to_model(x, tp)
        kv_x = None if kv_x is None else sharding.copy_to_model(kv_x, tp)
        params = local_heads(params, cfg, tp)
    k_pos = positions if kv_x is None else kv_positions
    q, k, v = qkv_project(params, x, kv_x)
    if rope:
        q = rotary_embed(q, positions, cfg.rope_theta)
        k = rotary_embed(k, k_pos, cfg.rope_theta)
    out = attend(q, k, v, q_pos=positions, k_pos=k_pos, causal=causal,
                 window=window, prefix=prefix,
                 logit_cap=cfg.attn_logit_softcap, kernel_impl=impl)
    return sharding.reduce_sum(out_project(params, out), tp), k, v


def context_attention(params, x, cfg: ArchConfig, axis, *, positions,
                      causal=True, window: int = 0, prefix: int = 0,
                      rope: bool = False, kv_x=None, kv_positions=None,
                      impl: Optional[str] = None):
    """``layer_attention`` context-parallel over ``axis`` (the
    reference's sequence-sharded ``shard_attn_act``), with the whole
    params: the rank takes its block of the q rows, [r0, r1) of S in
    the reference's plain contiguous split, every head.  Self-attention
    truncates its keys and values to the end of that block (causal:
    no later key is visible), so the rank's rows sit at their true
    positions under K11's suffix alignment (query row r at Sk - Sq + r,
    with any prefix and window); cross-attention and non-causal
    attention keep every key.  The rank applies ``wo`` to its own rows,
    which are then gathered along the sequence (``gather_dim``).  x,
    ``kv_x`` and the params go through ``copy_to_model``: each rank
    uses them in part, so their gradients (the keys' and values' over
    the whole sequence among them) are summed over ``axis``."""
    s = x.shape[1]
    n = s // axis.size
    r0, r1 = axis.rank * n, (axis.rank + 1) * n
    self_attn = kv_x is None
    end = r1 if causal and self_attn else (s if self_attn
                                            else kv_x.shape[1])
    if (causal or window or prefix) and end - n != r0:
        # K11 reads no positions: its mask is right only where the q
        # rows are the suffix of the keys
        raise ValueError(f"context-parallel attention: q rows [{r0}, {r1}) "
                         f"are not the suffix of keys [0, {end}) under a "
                         "mask that reads positions")
    x = sharding.copy_to_model(x, axis)
    kv_x = x if self_attn else sharding.copy_to_model(kv_x, axis)
    kv_positions = positions if self_attn else kv_positions
    params = sharding.copy_params_to_model(params, axis)
    q_pos, k_pos = positions[r0:r1], kv_positions[:end]
    q, k, v = qkv_project(params, x[:, r0:r1], kv_x[:, :end])
    if rope:
        q = rotary_embed(q, q_pos, cfg.rope_theta)
        k = rotary_embed(k, k_pos, cfg.rope_theta)
    out = attend(q, k, v, q_pos=q_pos, k_pos=k_pos, causal=causal,
                 window=window, prefix=prefix,
                 logit_cap=cfg.attn_logit_softcap, kernel_impl=impl)
    return sharding.gather_dim(out_project(params, out), axis, 1), k, v


# ----------------------------------------------------------------- KV caches

def init_cache(batch: int, capacity: int, n_kv_heads: int, head_dim: int,
               dtype, device=None):
    """Ring-buffer KV cache. ``pos[c]`` holds the absolute position stored
    in slot c (or -1)."""
    shape = (batch, capacity, n_kv_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.full((capacity,), -1, dtype=torch.int32,
                              device=device)}


def cache_slot(cur_index, capacity: int, window: int, prefix: int):
    """Slot for absolute position(s) ``cur_index`` (an int or an int
    tensor). Full caches: identity. Windowed: the first ``prefix`` slots
    are pinned, the rest is a ring."""
    if window and capacity < 10 ** 9:
        ring = max(capacity - prefix, 1)
        if isinstance(cur_index, torch.Tensor):
            return torch.where(cur_index < prefix, cur_index,
                               prefix + (cur_index - prefix) % ring)
        return (cur_index if cur_index < prefix
                else prefix + (cur_index - prefix) % ring)
    return cur_index


def cache_update(cache, k_new, v_new, cur_index: int, *, window=0,
                 prefix=0):
    """Insert one step (B,1,KV,Dh) at absolute position ``cur_index``, in
    place."""
    slot = int(cache_slot(int(cur_index), cache["k"].shape[1], window,
                          prefix))
    cache["k"][:, slot] = k_new[:, 0]
    cache["v"][:, slot] = v_new[:, 0]
    cache["pos"][slot] = int(cur_index)
    return cache


def cache_fill(cache, k, v, *, window=0, prefix=0):
    """Bulk-fill a cache in place from full-sequence K/V (B,S,KV,Dh) after
    prefill.  Windowed ring caches keep only the last ``capacity -
    prefix`` positions plus the pinned prefix; the slot map matches
    ``cache_slot``."""
    cap = cache["k"].shape[1]
    s = k.shape[1]
    dev = cache["pos"].device
    if window and s > cap:
        keep = torch.cat([torch.arange(prefix, device=dev),
                          torch.arange(s - (cap - prefix), s, device=dev)])
        slots = cache_slot(keep, cap, window, prefix)
        cache["k"][:, slots] = k[:, keep].to(cache["k"].dtype)
        cache["v"][:, slots] = v[:, keep].to(cache["v"].dtype)
        cache["pos"][slots] = keep.to(torch.int32)
        return cache
    # full cache (or prompt shorter than capacity): positions are slots
    cache["k"][:, :s] = k
    cache["v"][:, :s] = v
    cache["pos"][:s] = torch.arange(s, dtype=torch.int32, device=dev)
    return cache


def decode_attention(q, cache, cur_index: int, *, window=0, prefix=0,
                     logit_cap=0.0) -> torch.Tensor:
    """One-token attention against the cache. q (B,1,H,Dh) -> (B,1,H,Dh)."""
    b, one, h, dh = q.shape
    k, v, pos = cache["k"], cache["v"], cache["pos"]
    kvh = k.shape[2]
    qg = q.reshape(b, one, kvh, h // kvh, dh)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float() * dh ** -0.5
    s = softcap(s, logit_cap)
    ok = (pos >= 0) & (pos <= cur_index)
    if window:
        ok = ok & (((cur_index - pos) < window) | (pos < prefix))
    s = s.masked_fill(~ok, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype), v)
    return out.reshape(b, one, h, dh)
