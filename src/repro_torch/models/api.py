"""Unified model API (the port of ``repro/models/api.py``):
``init_params(seed, cfg)``, ``forward(params, cfg, batch)``,
``init_serve_state(...)`` / ``serve_decode_step(...)`` dispatch on
``cfg.family``.  The port serves the dense and ssm families; audio
(whisper's encoder-decoder) raises ``NotImplementedError``, as the moe,
hybrid and vlm families do in ``transformer`` (ROADMAP.md queue 7).

Batch dict keys: ``tokens`` (B,S) int32 (the vlm family's ``patches``
and audio's ``frames`` come with those families).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch

from repro_torch.config import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer

__all__ = ["init_params", "forward", "init_serve_state",
           "serve_decode_step"]


def _no_audio(cfg: ArchConfig) -> None:
    if cfg.family == "audio":
        raise NotImplementedError(
            f"{cfg.arch_id}: the audio (encoder-decoder) family is not "
            "ported yet (ROADMAP.md queue 7)")


def init_params(key: Union[int, torch.Generator], cfg: ArchConfig, *,
                device=None):
    """Random params: ``key`` is a seed, drawn from a generator on
    ``device`` (``None``: the CUDA device), or a ``torch.Generator``,
    whose device they go to."""
    _no_audio(cfg)
    if isinstance(key, torch.Generator):
        resolve_device(key.device)
        return transformer.init_lm(key, cfg)
    gen = torch.Generator(device=resolve_device(device)).manual_seed(key)
    return transformer.init_lm(gen, cfg)


def forward(params, cfg: ArchConfig, batch: Dict[str, Any], *,
            impl: Optional[str] = None):
    """Full-sequence forward -> (logits, aux_loss, n_prefix)."""
    _no_audio(cfg)
    return transformer.forward_lm(params, cfg, batch["tokens"], impl=impl)


# ------------------------------------------------------------------ serving

def init_serve_state(params, cfg: ArchConfig, batch: int, context_len: int,
                     *, device=None):
    _no_audio(cfg)
    if device is None:
        device = params["embed"].device
    return transformer.init_decode_state(cfg, batch, context_len,
                                         device=device)


def serve_decode_step(params, cfg: ArchConfig, caches, cur_index: int,
                      token):
    _no_audio(cfg)
    return transformer.decode_step(params, cfg, caches, cur_index, token)
