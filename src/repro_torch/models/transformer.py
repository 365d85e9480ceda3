"""Decoder-LM assembly for the dense, moe, ssm, hybrid and vlm families
(the port of ``repro/models/transformer.py``).

Forward, prefill and decode run Python loops over layers of the stacked
params (leading ``L`` axis), and per-layer cache shapes may differ
(ring-buffer windowed caches vs full-context caches vs SSM state).
``forward_lm`` is the training forward: with ``remat`` (the default)
each layer runs under ``torch.utils.checkpoint`` (non-reentrant) while
grad mode is on, so its activations are recomputed in the backward, as
the reference's ``jax.checkpoint``-ed layer scan does; it takes every
layer's params once (``layers_of``).  The reference's ``unroll`` only
shapes XLA's program (a Python loop in place of the scan) and is not
ported: the port's loop is already unrolled.  The reference's
layer-scanned ``prefill_scanned``/``decode_step_scanned`` exist to keep
XLA's programs small and are not ported.  ``force_window`` (the
long_500k serving shape, ``launch.specs.build_decode``) puts every
attention layer on a ring cache of ``sliding_window`` slots, so a
decode at a context of 524,288 holds O(window) keys a layer.

Families: hybrid (hymba) runs attention and Mamba2 side by side on one
normed input, with ``hybrid_meta_tokens`` learned tokens prepended and
pinned in every windowed cache (attention's ``prefix``); moe swaps the
GLU MLP for ``models/moe``; vlm prepends the projected patch embeddings
(``extra_embeds``), which attention sees as ordinary causal positions.
Positions are absolute and count the prepended tokens.

``impl`` selects the kernels (K11 and K12): ``None`` launches each
kernel on a CUDA tensor and takes the reference's full/chunked attention
and the plain scan on the CPU; ``"ref"`` takes the plain versions
everywhere.  ``scan_impl``, where given, overrides ``impl`` for K12
alone: training passes ``"ref"`` (K12 has no backward).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import sharding
from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (dense_init, dtype_of, embed_init,
                                       glu_mlp, init_glu_mlp, init_rmsnorm,
                                       layer_of, layers_of, rmsnorm,
                                       rotary_embed, softcap, stacked)

__all__ = ["layer_windows", "init_layer", "init_lm", "block_forward",
           "embed_inputs", "lm_logits", "forward_lm", "init_decode_state",
           "decode_step", "prefill"]


# ------------------------------------------------------------ layer metadata

def layer_windows(cfg: ArchConfig, *, force_window: bool = False
                  ) -> List[int]:
    """Per-layer sliding window (0 = full attention): gemma2-style
    local/global alternation keeps even layers local; hymba's
    ``hybrid_global_layers`` attend in full.  ``force_window`` gives
    those global layers ``sliding_window`` too (a config with no window
    keeps 0)."""
    if cfg.local_global_alternate:
        return [cfg.sliding_window if i % 2 == 0 or force_window else 0
                for i in range(cfg.n_layers)]
    if cfg.family == "hybrid":
        return [0 if i in cfg.hybrid_global_layers and not force_window
                else cfg.sliding_window for i in range(cfg.n_layers)]
    return [cfg.sliding_window] * cfg.n_layers


# ------------------------------------------------------------------- init

def init_layer(gen: torch.Generator, cfg: ArchConfig):
    dt = dtype_of(cfg.param_dtype)
    d = cfg.d_model
    dev = gen.device
    if cfg.family == "ssm":
        return {"norm": init_rmsnorm(d, device=dev),
                "mamba": ssm_mod.init_mamba(gen, d, cfg.ssm, dt)}
    if cfg.family == "hybrid":
        return {"input_norm": init_rmsnorm(d, device=dev),
                "attn": attn_mod.init_attention(gen, cfg, dt),
                "mamba": ssm_mod.init_mamba(gen, d, cfg.ssm, dt),
                "attn_out_norm": init_rmsnorm(d, device=dev),
                "ssm_out_norm": init_rmsnorm(d, device=dev),
                "mlp_norm": init_rmsnorm(d, device=dev),
                "mlp": init_glu_mlp(gen, d, cfg.d_ff, dt)}
    # dense / moe / the vlm's LM backbone
    p: Dict[str, Any] = {
        "attn_norm": init_rmsnorm(d, device=dev),
        "attn": attn_mod.init_attention(gen, cfg, dt),
        "mlp_norm": init_rmsnorm(d, device=dev),
    }
    if cfg.moe is not None:
        p["moe"] = moe_mod.init_moe(gen, d, cfg.d_ff, cfg.moe, dt)
    else:
        p["mlp"] = init_glu_mlp(gen, d, cfg.d_ff, dt)
    if cfg.sandwich_norms:
        p["post_attn_norm"] = init_rmsnorm(d, device=dev)
        p["post_mlp_norm"] = init_rmsnorm(d, device=dev)
    return p


def init_lm(gen: torch.Generator, cfg: ArchConfig):
    """Random params on ``gen``'s device (draws are not ``jax.random``'s:
    ``models.layers``)."""
    dt = dtype_of(cfg.param_dtype)
    d = cfg.d_model
    params: Dict[str, Any] = {
        "embed": embed_init(gen, cfg.vocab_padded, d, dt),
        "layers": stacked(init_layer, gen, cfg.n_layers, cfg),
        "final_norm": init_rmsnorm(d, device=gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, d, cfg.vocab_padded, dt)
    if cfg.hybrid_meta_tokens:
        params["meta_tokens"] = (torch.randn(
            (cfg.hybrid_meta_tokens, d), generator=gen, device=gen.device)
            * 0.02).to(dt)
    if cfg.vision_tokens:
        params["vision_proj"] = dense_init(gen, d, d, dt)
    return params


# --------------------------------------------------------------- block fwd

def _attention_path(lp, x_norm, cfg: ArchConfig, positions, window, prefix,
                    impl):
    """Causal self-attention with rotary, tensor- or context-parallel
    under a mesh (``attention.layer_attention``)."""
    return attn_mod.layer_attention(
        lp, x_norm, cfg, positions=positions, causal=True, window=window,
        prefix=prefix, rope=True, impl=impl)


def _ffn_path(lp, x, cfg: ArchConfig):
    """The dense/moe block's second half: x + (post-norm'd) GLU MLP or
    MoE.  Returns (x, aux_loss or None)."""
    h = rmsnorm(lp["mlp_norm"], x, cfg.norm_eps)
    aux = None
    if cfg.moe is not None:
        m, aux = moe_mod.moe_forward(lp["moe"], h, cfg.moe)
    else:
        m = glu_mlp(lp["mlp"], h, cfg.mlp_act, cfg.d_ff)
    if cfg.sandwich_norms:
        m = rmsnorm(lp["post_mlp_norm"], m, cfg.norm_eps)
    return x + m, aux


def _hybrid_mix(lp, x, a, s, cfg: ArchConfig):
    """The hybrid block after its two mixers: x + ½(norm(a) + norm(s)),
    then x + the GLU MLP."""
    eps = cfg.norm_eps
    x = x + 0.5 * (rmsnorm(lp["attn_out_norm"], a, eps)
                   + rmsnorm(lp["ssm_out_norm"], s, eps))
    return x + glu_mlp(lp["mlp"], rmsnorm(lp["mlp_norm"], x, eps),
                       cfg.mlp_act, cfg.d_ff)


def block_forward(lp, x, cfg: ArchConfig, positions, window: int,
                  impl: Optional[str] = None,
                  scan_impl: Optional[str] = None):
    """One decoder block. Returns (x, aux_loss)."""
    eps = cfg.norm_eps
    scan_impl = impl if scan_impl is None else scan_impl
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "ssm":
        h = rmsnorm(lp["norm"], x, eps)
        return (x + ssm_mod.mamba_forward(lp["mamba"], h, cfg.ssm,
                                          scan_impl), aux)
    if cfg.family == "hybrid":
        h = rmsnorm(lp["input_norm"], x, eps)
        a, _, _ = _attention_path(lp["attn"], h, cfg, positions, window,
                                  cfg.hybrid_meta_tokens, impl)
        s = ssm_mod.mamba_forward(lp["mamba"], h, cfg.ssm, scan_impl)
        return _hybrid_mix(lp, x, a, s, cfg), aux
    h = rmsnorm(lp["attn_norm"], x, eps)
    a, _, _ = _attention_path(lp["attn"], h, cfg, positions, window, 0, impl)
    if cfg.sandwich_norms:
        a = rmsnorm(lp["post_attn_norm"], a, eps)
    x, moe_aux = _ffn_path(lp, x + a, cfg)
    return x, aux if moe_aux is None else moe_aux


# ----------------------------------------------------------------- forward

def _embed_tokens(params, cfg: ArchConfig, tokens):
    """The token embeddings; vocab-parallel where ``embed`` holds the
    rank's rows: ids outside them read zeros, the ranks' rows summed."""
    dt = dtype_of(cfg.dtype)
    emb = params["embed"]
    tp = sharding.tp_axis(emb.shape[0], cfg.vocab_padded)
    if tp is None:
        x = emb[tokens.long()].to(dt)
    else:
        ids = tokens.long() - tp.rank * emb.shape[0]
        ok = (ids >= 0) & (ids < emb.shape[0])
        x = emb[ids.clamp(0, emb.shape[0] - 1)].to(dt)
        x = sharding.reduce_sum(
            torch.where(ok[..., None], x, torch.zeros((), dtype=dt,
                                                      device=x.device)), tp)
    if cfg.scale_embed:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dt)
    return x


def embed_inputs(params, cfg: ArchConfig, tokens, extra_embeds=None):
    """tokens (B,S) [+ vlm patch embeds (B,P,D)] -> (x (B,S',D),
    n_prefix): the projected patches, then hymba's meta tokens, go in
    front of the tokens."""
    dt = dtype_of(cfg.dtype)
    x = _embed_tokens(params, cfg, tokens)
    n_prefix = 0
    if cfg.vision_tokens and extra_embeds is not None:
        patches = extra_embeds.to(dt) @ params["vision_proj"].to(dt)
        x = torch.cat([patches, x], dim=1)
        n_prefix += patches.shape[1]
    if cfg.hybrid_meta_tokens:
        meta = params["meta_tokens"].to(dt)[None].expand(
            (x.shape[0],) + tuple(params["meta_tokens"].shape))
        x = torch.cat([meta, x], dim=1)
        n_prefix += cfg.hybrid_meta_tokens
    return x, n_prefix


def lm_logits(params, cfg: ArchConfig, x):
    """Logits in f32; where the head holds the rank's vocab block, its
    block of the logits, gathered over ``model``."""
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    tp = sharding.tp_axis(head.shape[-1], cfg.vocab_padded)
    logits = sharding.copy_to_model(x, tp) @ head.to(x.dtype)
    logits = sharding.gather_dim(logits, tp, -1)
    return softcap(logits.float(), cfg.final_logit_softcap)


def forward_lm(params, cfg: ArchConfig, tokens, extra_embeds=None, *,
               remat: bool = True, impl: Optional[str] = None,
               scan_impl: Optional[str] = None):
    """Full-sequence forward. Returns (logits (B,S',Vp), aux_loss,
    n_prefix).  ``remat`` recomputes each layer in the backward (only
    while grad mode is on; the values are the same either way).

    Under an active mesh (``sharding.lm_layout``) ``params`` are this
    rank's blocks and ``tokens`` its rows: the non-layer params are
    gathered once, each layer's inside its checkpoint (so the recompute
    gathers them again), and the logits are this rank's rows."""
    lay = sharding.lm_layout(cfg)
    top = params if lay is None else lay.gather_top(params)
    x, n_prefix = embed_inputs(top, cfg, tokens, extra_embeds)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    wins = layer_windows(cfg)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = remat and torch.is_grad_enabled()
    for i, lp in enumerate(layers_of(params["layers"], cfg.n_layers)):
        args = (lp, x, cfg, positions, wins[i], impl, scan_impl, lay)
        if remat:
            x, aux = checkpoint(_layer_forward, *args, use_reentrant=False)
        else:
            x, aux = _layer_forward(*args)
        aux_total = aux_total + aux
    return lm_logits(top, cfg, x), aux_total, n_prefix


def _layer_forward(lp, x, cfg, positions, window, impl, scan_impl, lay):
    """``block_forward`` on the layer's params, gathered first under a
    mesh."""
    if lay is not None:
        lp = lay.gather_layer(lp)
    return block_forward(lp, x, cfg, positions, window, impl, scan_impl)


# ------------------------------------------------------------------ decode

def init_decode_state(cfg: ArchConfig, batch: int, context_len: int, *,
                      force_window: bool = False, device=None):
    """Per-layer cache list sized for decoding with ``context_len`` history.
    A full-attention layer also holds the prepended meta tokens and
    patches; a windowed one the pinned meta tokens plus its window."""
    dt = dtype_of(cfg.dtype)
    prefix = cfg.hybrid_meta_tokens
    cap_full = context_len + cfg.hybrid_meta_tokens + cfg.vision_tokens
    wins = layer_windows(cfg, force_window=force_window)
    caches: List[Any] = []
    for i in range(cfg.n_layers):
        entry: Dict[str, Any] = {}
        if cfg.family != "ssm":
            cap = (prefix + min(wins[i], context_len)) if wins[i] else cap_full
            entry["attn"] = attn_mod.init_cache(
                batch, cap, cfg.n_kv_heads, cfg.resolved_head_dim, dt,
                device=device)
        if cfg.family in ("ssm", "hybrid"):
            entry["ssm"] = ssm_mod.init_mamba_cache(
                batch, cfg.d_model, cfg.ssm, dt, device=device)
        caches.append(entry)
    return caches


def _decode_attn(lp, cfg, x_norm, cache, cur_index: int, window: int,
                 prefix: int = 0):
    q, k, v = attn_mod.qkv_project(lp, x_norm)
    pos = torch.tensor([cur_index], dtype=torch.int32, device=x_norm.device)
    q = rotary_embed(q, pos, cfg.rope_theta)
    k = rotary_embed(k, pos, cfg.rope_theta)
    cache = attn_mod.cache_update(cache, k, v, cur_index, window=window,
                                  prefix=prefix)
    out = attn_mod.decode_attention(q, cache, cur_index, window=window,
                                    prefix=prefix,
                                    logit_cap=cfg.attn_logit_softcap)
    return attn_mod.out_project(lp, out), cache


def decode_step(params, cfg: ArchConfig, caches, cur_index: int, token, *,
                force_window: bool = False):
    """One decode step. token: (B,) int32; cur_index: the absolute position
    (a Python int, counting any meta tokens and patches). Returns (logits
    (B,Vp), caches); attention caches are updated in place.
    ``force_window`` must be the one the caches were made with."""
    cur_index = int(cur_index)
    eps = cfg.norm_eps
    prefix = cfg.hybrid_meta_tokens
    x = _embed_tokens(params, cfg, token[:, None])                # (B,1,D)
    wins = layer_windows(cfg, force_window=force_window)
    new_caches = []
    for i in range(cfg.n_layers):
        lp = layer_of(params["layers"], i)
        entry = dict(caches[i])
        if cfg.family == "ssm":
            h = rmsnorm(lp["norm"], x, eps)
            y, entry["ssm"] = ssm_mod.mamba_decode_step(
                lp["mamba"], h, entry["ssm"], cfg.ssm)
            x = x + y
        elif cfg.family == "hybrid":
            h = rmsnorm(lp["input_norm"], x, eps)
            a, entry["attn"] = _decode_attn(lp["attn"], cfg, h, entry["attn"],
                                            cur_index, wins[i], prefix)
            s, entry["ssm"] = ssm_mod.mamba_decode_step(
                lp["mamba"], h, entry["ssm"], cfg.ssm)
            x = _hybrid_mix(lp, x, a, s, cfg)
        else:
            h = rmsnorm(lp["attn_norm"], x, eps)
            a, entry["attn"] = _decode_attn(lp["attn"], cfg, h, entry["attn"],
                                            cur_index, wins[i])
            if cfg.sandwich_norms:
                a = rmsnorm(lp["post_attn_norm"], a, eps)
            x, _ = _ffn_path(lp, x + a, cfg)
        new_caches.append(entry)
    return lm_logits(params, cfg, x)[:, 0], new_caches


def _attn_prefill(lp, cfg, h, cache, positions, window, prefix, impl):
    a, k, v = _attention_path(lp, h, cfg, positions, window, prefix, impl)
    attn_mod.cache_fill(cache, k, v, window=window, prefix=prefix)
    return a


def prefill(params, cfg: ArchConfig, tokens, extra_embeds=None, *,
            context_len: Optional[int] = None, force_window: bool = False,
            impl: Optional[str] = None, last_only: bool = False):
    """Run the full prompt (after any patches and meta tokens) and build
    decode caches.

    Returns (logits (B,S',Vp) — or (B,1,Vp) when ``last_only``, the
    serving fast path that avoids materializing seq×vocab logits —,
    caches, next_index (an int, the absolute position of the next
    token)).
    """
    eps = cfg.norm_eps
    x, _ = embed_inputs(params, cfg, tokens, extra_embeds)
    b, s_total, _ = x.shape
    context_len = context_len or s_total
    positions = torch.arange(s_total, dtype=torch.int32, device=x.device)
    wins = layer_windows(cfg, force_window=force_window)
    prefix = cfg.hybrid_meta_tokens
    caches = init_decode_state(cfg, b, context_len,
                               force_window=force_window, device=x.device)
    for i in range(cfg.n_layers):
        lp = layer_of(params["layers"], i)
        entry = caches[i]
        if cfg.family == "ssm":
            h = rmsnorm(lp["norm"], x, eps)
            y, state, conv = ssm_mod.mamba_forward_with_state(
                lp["mamba"], h, cfg.ssm, impl)
            x = x + y
            entry["ssm"] = {"state": state, "conv": conv}
        elif cfg.family == "hybrid":
            h = rmsnorm(lp["input_norm"], x, eps)
            a = _attn_prefill(lp["attn"], cfg, h, entry["attn"], positions,
                              wins[i], prefix, impl)
            s, state, conv = ssm_mod.mamba_forward_with_state(
                lp["mamba"], h, cfg.ssm, impl)
            entry["ssm"] = {"state": state, "conv": conv}
            x = _hybrid_mix(lp, x, a, s, cfg)
        else:
            h = rmsnorm(lp["attn_norm"], x, eps)
            a = _attn_prefill(lp["attn"], cfg, h, entry["attn"], positions,
                              wins[i], 0, impl)
            if cfg.sandwich_norms:
                a = rmsnorm(lp["post_attn_norm"], a, eps)
            x, _ = _ffn_path(lp, x + a, cfg)
    logits = lm_logits(params, cfg, x[:, -1:] if last_only else x)
    return logits, caches, s_total
