"""LLM serving: batched prefill + single-token greedy decode steps (the
port of ``repro/serve/engine.py``).

``make_prefill_step`` runs a prompt (after any vlm patches and hybrid
meta tokens) through every layer (on the card: K11 in every attention
layer, K12 in every Mamba2 mixer) and builds the decode caches;
``make_serve_step`` decodes ONE new token against them; ``greedy_decode``
chains the two, or, for the encoder-decoder (audio), encodes the frames
(K11 in every encoder layer), teacher-forces the prompt through the
decoder's cache and decodes (K11 in every cross-attention).
``impl="ref"`` runs the kernels' plain versions on any device.
``force_window`` (the long_500k shape) puts every attention layer on a
ring cache of its window, in the prefill and the steps alike.  Serving
needs no gradient, so everything runs under ``torch.no_grad()`` (K12 has
no backward and refuses operands that require grad; K11's backward is
for training, ``train/steps``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import api, encdec, transformer

__all__ = ["serve_context_len", "make_prefill_step", "make_serve_step",
           "greedy_decode"]


def serve_context_len(cfg: ArchConfig, n_prompt: int, n_new: int,
                      extra_embeds: Optional[torch.Tensor] = None) -> int:
    """The context ``greedy_decode`` sizes the decode caches for, as the
    reference does: the prompt, the new tokens, the extra embeddings'
    rows (the vlm's patches) and the hybrid meta tokens."""
    n_extra = extra_embeds.shape[1] if extra_embeds is not None else 0
    return n_prompt + n_new + n_extra + cfg.hybrid_meta_tokens


def make_prefill_step(cfg: ArchConfig, *, context_len: int,
                      force_window: bool = False,
                      impl: Optional[str] = None, last_only: bool = False):
    """prefill_step(params, batch) -> (logits, caches, next_index)."""

    @torch.no_grad()
    def prefill_step(params, batch):
        return transformer.prefill(
            params, cfg, batch["tokens"], api.extra_embeds_of(cfg, batch),
            context_len=context_len, force_window=force_window, impl=impl,
            last_only=last_only)
    return prefill_step


def make_serve_step(cfg: ArchConfig, *, force_window: bool = False,
                    impl: Optional[str] = None):
    """serve_step(params, caches, cur_index, token) -> (next_token, logits,
    caches)."""

    @torch.no_grad()
    def serve_step(params, caches, cur_index, token):
        logits, caches = api.serve_decode_step(
            params, cfg, caches, cur_index, token,
            force_window=force_window, impl=impl)
        next_token = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_token, logits, caches
    return serve_step


@torch.no_grad()
def greedy_decode(params, cfg: ArchConfig, prompt_tokens: torch.Tensor,
                  n_new: int, *, extra_embeds: Optional[torch.Tensor] = None,
                  force_window: bool = False,
                  impl: Optional[str] = None) -> torch.Tensor:
    """Prefill a prompt (B,S) then greedily decode ``n_new`` tokens ->
    (B, n_new) int32.  ``extra_embeds``: the vlm's patches, or the audio
    family's encoder frames."""
    if prompt_tokens.shape[1] == 0:
        # decoding starts from the last prompt logits; with no prompt
        # token there is nothing to condition on
        raise ValueError("greedy_decode needs at least one prompt token "
                         "(got an empty prompt)")
    step = make_serve_step(cfg, force_window=force_window, impl=impl)
    if cfg.family == "audio":
        memory = encdec.encode(params, cfg, extra_embeds, impl=impl)
        b, s = prompt_tokens.shape
        caches = encdec.init_decode_state(params, cfg, b, s + n_new, memory)
        for t in range(s):          # teacher-force the prompt through the cache
            cur, _, caches = step(params, caches, t, prompt_tokens[:, t])
        out = []
        for t in range(s, s + n_new):
            out.append(cur)
            cur, _, caches = step(params, caches, t, cur)
        return torch.stack(out, dim=1)
    prefill = make_prefill_step(
        cfg, context_len=serve_context_len(cfg, prompt_tokens.shape[1],
                                           n_new, extra_embeds),
        force_window=force_window, impl=impl, last_only=True)
    logits, caches, next_idx = prefill(
        params, {"tokens": prompt_tokens, "patches": extra_embeds})
    cur = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    out = []
    for t in range(n_new):
        out.append(cur)
        cur, _, caches = step(params, caches, next_idx + t, cur)
    return torch.stack(out, dim=1)
