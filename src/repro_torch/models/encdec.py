"""Whisper-style encoder-decoder backbone, the audio family (the port of
``repro/models/encdec.py``).

The mel-spectrogram + conv frontend is a stub, as in the reference:
callers give precomputed frame embeddings (B, enc_seq, d_model).  A
bidirectional encoder runs over the frames (sinusoidal positions), a
causal decoder (learned positions, a 40,960-row table) with
cross-attention to the encoder memory.  LayerNorm, GELU MLPs, biases on
q/k/v per the config.

Attention: the encoder's is ``attend(impl=None)``, which is K11
non-causal on a CUDA tensor and the reference's own full/chunked rule on
the CPU.  The reference hard-codes ``"full"`` there (below 8,192 frames);
taking the kernel on the card is the port's deliberate choice, the one
it makes for ``attend(None)`` everywhere (ROADMAP.md §3, R4).  The
decoder's cross-attention in ``decode_step`` is ``attend(causal=False)``
at one query, so K11 on the card too; its self-attention against the
cache stays the plain ``decode_attention``, as in the reference.
``impl="ref"`` takes the plain versions everywhere.

``forward_encdec`` (the training forward) runs each encoder and decoder
layer under ``torch.utils.checkpoint`` (non-reentrant) while grad mode
is on and ``remat`` (the default) asks, as the reference checkpoints its
encoder and decoder scan bodies; K11's backward then runs in every
encoder layer, self-attention and cross-attention (Sq ≠ Sk).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import sharding
from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import (dtype_of, embed_init, gelu_mlp,
                                       init_gelu_mlp, init_layernorm,
                                       layer_of, layernorm, layers_of,
                                       sinusoidal_positions, stacked)

__all__ = ["init_enc_layer", "init_dec_layer", "init_encdec", "encode",
           "decode_train", "forward_encdec", "init_decode_state",
           "decode_step"]


# ------------------------------------------------------------------- init

def init_enc_layer(gen: torch.Generator, cfg: ArchConfig):
    dt = dtype_of(cfg.param_dtype)
    d, dev = cfg.d_model, gen.device
    return {"attn_norm": init_layernorm(d, device=dev),
            "attn": attn_mod.init_attention(gen, cfg, dt),
            "mlp_norm": init_layernorm(d, device=dev),
            "mlp": init_gelu_mlp(gen, d, cfg.d_ff, dt)}


def init_dec_layer(gen: torch.Generator, cfg: ArchConfig):
    dt = dtype_of(cfg.param_dtype)
    d, dev = cfg.d_model, gen.device
    return {"attn_norm": init_layernorm(d, device=dev),
            "attn": attn_mod.init_attention(gen, cfg, dt),
            "cross_norm": init_layernorm(d, device=dev),
            "cross_attn": attn_mod.init_attention(gen, cfg, dt),
            "mlp_norm": init_layernorm(d, device=dev),
            "mlp": init_gelu_mlp(gen, d, cfg.d_ff, dt)}


def init_encdec(gen: torch.Generator, cfg: ArchConfig):
    """Random params on ``gen``'s device; the LM head is tied to
    ``embed``, as whisper's."""
    dt = dtype_of(cfg.param_dtype)
    d, dev = cfg.d_model, gen.device
    return {
        "embed": embed_init(gen, cfg.vocab_padded, d, dt),
        # sized for 32k-token decoder shapes (the source model caps at
        # 448 positions)
        "dec_pos_embed": (torch.randn((40960, d), generator=gen, device=dev)
                          * 0.01).to(dt),
        "enc_layers": stacked(init_enc_layer, gen, cfg.enc_layers, cfg),
        "enc_final_norm": init_layernorm(d, device=dev),
        "dec_layers": stacked(init_dec_layer, gen, cfg.n_layers, cfg),
        "dec_final_norm": init_layernorm(d, device=dev),
    }


# ----------------------------------------------------------------- encoder

def _enc_block(lp, x, cfg: ArchConfig, positions, impl):
    """One encoder layer; under a mesh its attention tensor- or
    context-parallel (``attention.layer_attention``) and its MLP
    tensor-parallel where the layout kept their ``model`` shards."""
    eps = cfg.norm_eps
    h = layernorm(lp["attn_norm"], x, eps)
    a, _, _ = attn_mod.layer_attention(lp["attn"], h, cfg,
                                       positions=positions, causal=False,
                                       impl=impl)
    x = x + a
    return x + gelu_mlp(lp["mlp"], layernorm(lp["mlp_norm"], x, eps),
                        cfg.d_ff)


def _run_layers(block, stack, n: int, x, remat: bool, *args, lay=None,
                name: str = "layers"):
    """``x`` through the ``n`` layers of ``stack``, each under the
    non-reentrant checkpoint while ``remat`` and grad mode are on; under
    a mesh (``lay``) each layer's params gathered whole inside it."""
    remat = remat and torch.is_grad_enabled()
    fn = block if lay is None else _gathered(block, lay, name)
    for lp in layers_of(stack, n):
        x = (checkpoint(fn, lp, x, *args, use_reentrant=False) if remat
             else fn(lp, x, *args))
    return x


def _gathered(block, lay, name: str):
    def run(lp, *args):
        return block(lay.gather_layer(lp, name), *args)
    return run


def encode(params, cfg: ArchConfig, frames: torch.Tensor, *,
           impl: Optional[str] = None, remat: bool = False) -> torch.Tensor:
    """frames (B,S_enc,D) stub frontend embeddings -> encoder memory
    (B,S_enc,D) in the compute dtype."""
    dt = dtype_of(cfg.dtype)
    s = frames.shape[1]
    pos_tab = torch.from_numpy(sinusoidal_positions(s, cfg.d_model)).to(
        frames.device, dt)
    x = frames.to(dt) + pos_tab[None]
    positions = torch.arange(s, dtype=torch.int32, device=frames.device)
    x = _run_layers(_enc_block, params["enc_layers"], cfg.enc_layers, x,
                    remat, cfg, positions, impl, lay=sharding.lm_layout(cfg),
                    name="enc_layers")
    return layernorm(params["enc_final_norm"], x, cfg.norm_eps)


# ----------------------------------------------------------------- decoder

def _dec_block(lp, x, memory, cfg: ArchConfig, positions, mem_positions,
               impl):
    """One decoder layer: causal self-attention, cross-attention to the
    encoder memory, the GELU MLP, each parallel as ``_enc_block``'s."""
    eps = cfg.norm_eps
    h = layernorm(lp["attn_norm"], x, eps)
    a, _, _ = attn_mod.layer_attention(lp["attn"], h, cfg,
                                       positions=positions, causal=True,
                                       impl=impl)
    x = x + a
    hc = layernorm(lp["cross_norm"], x, eps)
    c, _, _ = attn_mod.layer_attention(lp["cross_attn"], hc, cfg,
                                       positions=positions, causal=False,
                                       kv_x=memory,
                                       kv_positions=mem_positions, impl=impl)
    x = x + c
    return x + gelu_mlp(lp["mlp"], layernorm(lp["mlp_norm"], x, eps),
                        cfg.d_ff)


def _logits(params, cfg: ArchConfig, x):
    x = layernorm(params["dec_final_norm"], x, cfg.norm_eps)
    return (x @ params["embed"].T.to(x.dtype)).float()


def decode_train(params, cfg: ArchConfig, tokens, memory, *,
                 last_only: bool = False, impl: Optional[str] = None,
                 remat: bool = False):
    """Teacher-forced decoder pass. tokens (B,S) -> logits (B,S,Vp) f32."""
    dt = dtype_of(cfg.dtype)
    s = tokens.shape[1]
    x = params["embed"][tokens.long()].to(dt)
    x = x + params["dec_pos_embed"][None, :s].to(dt)
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    mem_positions = torch.arange(memory.shape[1], dtype=torch.int32,
                                 device=x.device)
    x = _run_layers(_dec_block, params["dec_layers"], cfg.n_layers, x,
                    remat, memory, cfg, positions, mem_positions, impl,
                    lay=sharding.lm_layout(cfg), name="dec_layers")
    return _logits(params, cfg, x[:, -1:] if last_only else x)


def forward_encdec(params, cfg: ArchConfig, tokens, frames, *,
                   last_only: bool = False, impl: Optional[str] = None,
                   remat: bool = True):
    """Full encoder-decoder forward: (decoder tokens, encoder frames) ->
    logits; ``remat`` recomputes each layer in the backward.  Under an
    active mesh ``params`` are this rank's blocks and the inputs its
    rows: the non-layer params are gathered whole once, each layer's
    inside its checkpoint, but for the ``model`` shards tensor
    parallelism keeps (``sharding.LMLayout``: the attention heads, the
    MLPs' d_ff); attention whose heads do not divide ``model`` runs
    context-parallel where the sequence does."""
    lay = sharding.lm_layout(cfg)
    if lay is not None:
        params = lay.gather_top(params)
    memory = encode(params, cfg, frames, impl=impl, remat=remat)
    return decode_train(params, cfg, tokens, memory, last_only=last_only,
                        impl=impl, remat=remat)


# ------------------------------------------------------------------ decode

def init_decode_state(params, cfg: ArchConfig, batch: int, context_len: int,
                      memory: torch.Tensor):
    """Caches: each decoder layer's self-attention KV cache and the cross
    K/V of ``memory``, computed once."""
    dt = dtype_of(cfg.dtype)
    mem = memory.to(dt)
    caches: List[Dict[str, Any]] = []
    for i in range(cfg.n_layers):
        lp = layer_of(params["dec_layers"], i)
        _, kc, vc = attn_mod.qkv_project(lp["cross_attn"], mem[:, :1],
                                         kv_x=mem)
        caches.append({
            "attn": attn_mod.init_cache(batch, context_len, cfg.n_kv_heads,
                                        cfg.resolved_head_dim, dt,
                                        device=memory.device),
            "cross_k": kc, "cross_v": vc})
    return caches


def decode_step(params, cfg: ArchConfig, caches, cur_index: int, token, *,
                impl: Optional[str] = None):
    """One decoder token against its KV cache and the fixed cross memory.
    token (B,) int32, cur_index a Python int -> (logits (B,Vp) f32,
    caches); the self-attention caches are updated in place."""
    dt = dtype_of(cfg.dtype)
    eps = cfg.norm_eps
    cur_index = int(cur_index)
    x = params["embed"][token.long()][:, None].to(dt)
    x = x + params["dec_pos_embed"][None, cur_index:cur_index + 1].to(dt)
    q_pos = torch.zeros((1,), dtype=torch.int32, device=x.device)
    mem_positions = None
    new_caches = []
    for i in range(cfg.n_layers):
        lp = layer_of(params["dec_layers"], i)
        entry = dict(caches[i])
        h = layernorm(lp["attn_norm"], x, eps)
        q, k, v = attn_mod.qkv_project(lp["attn"], h)
        entry["attn"] = attn_mod.cache_update(entry["attn"], k, v, cur_index)
        a = attn_mod.decode_attention(q, entry["attn"], cur_index)
        x = x + attn_mod.out_project(lp["attn"], a)
        hc = layernorm(lp["cross_norm"], x, eps)
        qc = attn_mod.project(hc, lp["cross_attn"]["wq"])
        if "bq" in lp["cross_attn"]:
            qc = qc + lp["cross_attn"]["bq"].to(hc.dtype)
        kc, vc = entry["cross_k"], entry["cross_v"]
        if mem_positions is None:
            mem_positions = torch.arange(kc.shape[1], dtype=torch.int32,
                                         device=x.device)
        c = attn_mod.attend(qc, kc, vc, q_pos=q_pos, k_pos=mem_positions,
                            causal=False, kernel_impl=impl)
        x = x + attn_mod.out_project(lp["cross_attn"], c)
        x = x + gelu_mlp(lp["mlp"], layernorm(lp["mlp_norm"], x, eps))
        new_caches.append(entry)
    return _logits(params, cfg, x)[:, 0], new_caches
