"""LLM serving: batched prefill + single-token greedy decode steps (the
port of ``repro/serve/engine.py``).

``make_prefill_step`` runs a prompt through every layer (on the card:
K11 in every attention layer, K12 in every Mamba2 layer) and builds the
decode caches; ``make_serve_step`` decodes ONE new token against them;
``greedy_decode`` chains the two.  ``impl="ref"`` runs the kernels'
plain versions on any device (decode itself runs no kernel).  Serving
needs no gradient, so both steps run under ``torch.no_grad()``: K11 and
K12 have no backward and refuse operands that require grad.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import api, transformer

__all__ = ["make_prefill_step", "make_serve_step", "greedy_decode"]


def make_prefill_step(cfg: ArchConfig, *, context_len: int,
                      impl: Optional[str] = None, last_only: bool = False):
    """prefill_step(params, batch) -> (logits, caches, next_index)."""

    @torch.no_grad()
    def prefill_step(params, batch):
        return transformer.prefill(
            params, cfg, batch["tokens"], context_len=context_len,
            impl=impl, last_only=last_only)
    return prefill_step


def make_serve_step(cfg: ArchConfig):
    """serve_step(params, caches, cur_index, token) -> (next_token, logits,
    caches)."""

    @torch.no_grad()
    def serve_step(params, caches, cur_index, token):
        logits, caches = api.serve_decode_step(params, cfg, caches,
                                               cur_index, token)
        next_token = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_token, logits, caches
    return serve_step


def greedy_decode(params, cfg: ArchConfig, prompt_tokens: torch.Tensor,
                  n_new: int, *, impl: Optional[str] = None
                  ) -> torch.Tensor:
    """Prefill a prompt (B,S) then greedily decode ``n_new`` tokens ->
    (B, n_new) int32."""
    if prompt_tokens.shape[1] == 0:
        # decoding starts from the last prompt logits; with no prompt
        # token there is nothing to condition on
        raise ValueError("greedy_decode needs at least one prompt token "
                         "(got an empty prompt)")
    prefill_step = make_prefill_step(
        cfg, context_len=prompt_tokens.shape[1] + n_new, impl=impl,
        last_only=True)
    logits, caches, next_idx = prefill_step(params,
                                            {"tokens": prompt_tokens})
    cur = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    step = make_serve_step(cfg)
    out = []
    for t in range(n_new):
        out.append(cur)
        cur, _, caches = step(params, caches, next_idx + t, cur)
    return torch.stack(out, dim=1)
