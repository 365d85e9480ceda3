"""Decoder-LM assembly for the dense and ssm families (the port of
``repro/models/transformer.py``).

Forward, prefill and decode run Python loops over layers of the stacked
params (leading ``L`` axis): no ``remat`` or ``unroll`` (nothing here is
differentiated), and per-layer cache shapes may differ (ring-buffer
windowed caches vs full-context caches vs SSM state).  The moe, hybrid
and vlm families raise ``NotImplementedError`` (ROADMAP.md queue 7).  The
reference's layer-scanned ``prefill_scanned``/``decode_step_scanned``
exist to keep XLA's programs small and are not ported.

``impl`` selects the kernels (K11 and K12): ``None`` launches each
kernel on a CUDA tensor and takes the reference's full/chunked attention
and the plain scan on the CPU; ``"ref"`` takes the plain versions
everywhere.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (dense_init, dtype_of, embed_init,
                                       glu_mlp, init_glu_mlp, init_rmsnorm,
                                       rmsnorm, rotary_embed, softcap,
                                       stacked)

__all__ = ["layer_windows", "init_layer", "init_lm", "block_forward",
           "embed_inputs", "lm_logits", "forward_lm", "init_decode_state",
           "decode_step", "prefill"]

_FAMILIES = ("dense", "ssm")


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in _FAMILIES or cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.arch_id}: the {cfg.family} family is not ported yet "
            "(ROADMAP.md queue 7); the port serves the dense and ssm "
            "families")


# ------------------------------------------------------------ layer metadata

def layer_windows(cfg: ArchConfig) -> List[int]:
    """Per-layer sliding window (0 = full attention); gemma2-style
    local/global alternation keeps even layers local.  (The hybrid
    family's global layers come with that family, queue 7.)"""
    if not cfg.local_global_alternate:
        return [cfg.sliding_window] * cfg.n_layers
    return [cfg.sliding_window if i % 2 == 0 else 0
            for i in range(cfg.n_layers)]


# ------------------------------------------------------------------- init

def init_layer(gen: torch.Generator, cfg: ArchConfig):
    dt = dtype_of(cfg.param_dtype)
    d = cfg.d_model
    dev = gen.device
    if cfg.family == "ssm":
        return {"norm": init_rmsnorm(d, device=dev),
                "mamba": ssm_mod.init_mamba(gen, d, cfg.ssm, dt)}
    p: Dict[str, Any] = {
        "attn_norm": init_rmsnorm(d, device=dev),
        "attn": attn_mod.init_attention(
            gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, dt,
            use_bias=cfg.qkv_bias),
        "mlp_norm": init_rmsnorm(d, device=dev),
        "mlp": init_glu_mlp(gen, d, cfg.d_ff, dt),
    }
    if cfg.sandwich_norms:
        p["post_attn_norm"] = init_rmsnorm(d, device=dev)
        p["post_mlp_norm"] = init_rmsnorm(d, device=dev)
    return p


def init_lm(gen: torch.Generator, cfg: ArchConfig):
    """Random params on ``gen``'s device (draws are not ``jax.random``'s:
    ``models.layers``)."""
    _check_family(cfg)
    dt = dtype_of(cfg.param_dtype)
    params: Dict[str, Any] = {
        "embed": embed_init(gen, cfg.vocab_padded, cfg.d_model, dt),
        "layers": stacked(init_layer, gen, cfg.n_layers, cfg),
        "final_norm": init_rmsnorm(cfg.d_model, device=gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_padded, dt)
    return params


# --------------------------------------------------------------- block fwd

def _layer_params(params, i: int):
    def pick(tree):
        if isinstance(tree, dict):
            return {k: pick(v) for k, v in tree.items()}
        return tree[i]
    return pick(params["layers"])


def _attention_path(lp, x_norm, cfg: ArchConfig, positions, window, impl):
    q, k, v = attn_mod.qkv_project(lp, x_norm)
    q = rotary_embed(q, positions, cfg.rope_theta)
    k = rotary_embed(k, positions, cfg.rope_theta)
    out = attn_mod.attend(
        q, k, v, q_pos=positions, k_pos=positions, causal=True,
        window=window, logit_cap=cfg.attn_logit_softcap, kernel_impl=impl)
    return attn_mod.out_project(lp, out), k, v


def _mlp_path(lp, x, cfg: ArchConfig):
    """The dense block's second half: x + (post-norm'd) GLU MLP."""
    m = glu_mlp(lp["mlp"], rmsnorm(lp["mlp_norm"], x, cfg.norm_eps),
                cfg.mlp_act)
    if cfg.sandwich_norms:
        m = rmsnorm(lp["post_mlp_norm"], m, cfg.norm_eps)
    return x + m


def block_forward(lp, x, cfg: ArchConfig, positions, window: int,
                  impl: Optional[str] = None):
    """One decoder block. Returns (x, aux_loss)."""
    eps = cfg.norm_eps
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "ssm":
        h = rmsnorm(lp["norm"], x, eps)
        return x + ssm_mod.mamba_forward(lp["mamba"], h, cfg.ssm, impl), aux
    h = rmsnorm(lp["attn_norm"], x, eps)
    a, _, _ = _attention_path(lp["attn"], h, cfg, positions, window, impl)
    if cfg.sandwich_norms:
        a = rmsnorm(lp["post_attn_norm"], a, eps)
    return _mlp_path(lp, x + a, cfg), aux


# ----------------------------------------------------------------- forward

def embed_inputs(params, cfg: ArchConfig, tokens):
    """tokens (B,S) -> (x (B,S,D), n_prefix); the dense and ssm families
    prepend nothing (the vlm family's patches come with it, queue 7)."""
    _check_family(cfg)
    dt = dtype_of(cfg.dtype)
    x = params["embed"][tokens.long()].to(dt)
    if cfg.scale_embed:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dt)
    return x, 0


def lm_logits(params, cfg: ArchConfig, x):
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x @ head.to(x.dtype)
    return softcap(logits.float(), cfg.final_logit_softcap)


def forward_lm(params, cfg: ArchConfig, tokens, *,
               impl: Optional[str] = None):
    """Full-sequence forward. Returns (logits (B,S,Vp), aux_loss, n_prefix)."""
    x, n_prefix = embed_inputs(params, cfg, tokens)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    wins = layer_windows(cfg)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_layers):
        x, aux = block_forward(_layer_params(params, i), x, cfg, positions,
                               wins[i], impl)
        aux_total = aux_total + aux
    return lm_logits(params, cfg, x), aux_total, n_prefix


# ------------------------------------------------------------------ decode

def init_decode_state(cfg: ArchConfig, batch: int, context_len: int, *,
                      device=None):
    """Per-layer cache list sized for decoding with ``context_len`` history."""
    _check_family(cfg)
    dt = dtype_of(cfg.dtype)
    wins = layer_windows(cfg)
    caches: List[Any] = []
    for i in range(cfg.n_layers):
        if cfg.family == "ssm":
            caches.append({"ssm": ssm_mod.init_mamba_cache(
                batch, cfg.d_model, cfg.ssm, dt, device=device)})
            continue
        cap = min(wins[i], context_len) if wins[i] else context_len
        caches.append({"attn": attn_mod.init_cache(
            batch, cap, cfg.n_kv_heads, cfg.resolved_head_dim, dt,
            device=device)})
    return caches


def _decode_attn(lp, cfg, x_norm, cache, cur_index: int, window: int):
    q, k, v = attn_mod.qkv_project(lp, x_norm)
    pos = torch.tensor([cur_index], dtype=torch.int32, device=x_norm.device)
    q = rotary_embed(q, pos, cfg.rope_theta)
    k = rotary_embed(k, pos, cfg.rope_theta)
    cache = attn_mod.cache_update(cache, k, v, cur_index, window=window)
    out = attn_mod.decode_attention(q, cache, cur_index, window=window,
                                    logit_cap=cfg.attn_logit_softcap)
    return attn_mod.out_project(lp, out), cache


def decode_step(params, cfg: ArchConfig, caches, cur_index: int, token):
    """One decode step. token: (B,) int32; cur_index: the absolute position
    (a Python int). Returns (logits (B,Vp), caches); attention caches are
    updated in place."""
    cur_index = int(cur_index)
    eps = cfg.norm_eps
    x, _ = embed_inputs(params, cfg, token[:, None])              # (B,1,D)
    wins = layer_windows(cfg)
    new_caches = []
    for i in range(cfg.n_layers):
        lp = _layer_params(params, i)
        entry = dict(caches[i])
        if cfg.family == "ssm":
            h = rmsnorm(lp["norm"], x, eps)
            y, entry["ssm"] = ssm_mod.mamba_decode_step(
                lp["mamba"], h, entry["ssm"], cfg.ssm)
            x = x + y
        else:
            h = rmsnorm(lp["attn_norm"], x, eps)
            a, entry["attn"] = _decode_attn(lp["attn"], cfg, h, entry["attn"],
                                            cur_index, wins[i])
            if cfg.sandwich_norms:
                a = rmsnorm(lp["post_attn_norm"], a, eps)
            x = _mlp_path(lp, x + a, cfg)
        new_caches.append(entry)
    return lm_logits(params, cfg, x)[:, 0], new_caches


def prefill(params, cfg: ArchConfig, tokens, *,
            context_len: Optional[int] = None, impl: Optional[str] = None,
            last_only: bool = False):
    """Run the full prompt and build decode caches.

    Returns (logits (B,S,Vp) — or (B,1,Vp) when ``last_only``, the serving
    fast path that avoids materializing seq×vocab logits —, caches,
    next_index (an int)).
    """
    eps = cfg.norm_eps
    x, _ = embed_inputs(params, cfg, tokens)
    b, s_total, _ = x.shape
    context_len = context_len or s_total
    positions = torch.arange(s_total, dtype=torch.int32, device=x.device)
    wins = layer_windows(cfg)
    caches = init_decode_state(cfg, b, context_len, device=x.device)
    for i in range(cfg.n_layers):
        lp = _layer_params(params, i)
        entry = caches[i]
        if cfg.family == "ssm":
            h = rmsnorm(lp["norm"], x, eps)
            y, state, conv = ssm_mod.mamba_forward_with_state(
                lp["mamba"], h, cfg.ssm, impl)
            x = x + y
            entry["ssm"] = {"state": state, "conv": conv}
            continue
        h = rmsnorm(lp["attn_norm"], x, eps)
        a, k, v = _attention_path(lp["attn"], h, cfg, positions, wins[i],
                                  impl)
        attn_mod.cache_fill(entry["attn"], k, v, window=wins[i])
        if cfg.sandwich_norms:
            a = rmsnorm(lp["post_attn_norm"], a, eps)
        x = _mlp_path(lp, x + a, cfg)
    logits = lm_logits(params, cfg, x[:, -1:] if last_only else x)
    return logits, caches, s_total
