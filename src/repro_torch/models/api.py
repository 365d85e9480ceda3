"""Unified model API (the port of ``repro/models/api.py``):
``init_params(seed, cfg)``, ``forward(params, cfg, batch)``,
``init_serve_state(...)`` / ``serve_decode_step(...)`` dispatch on
``cfg.family``: the encoder-decoder (audio, whisper) to ``encdec``,
every decoder-only family to ``transformer``.

Batch dict keys: ``tokens`` (B,S) int32; ``patches`` (B,vision_tokens,D)
for the vlm family (stub patch embeddings); ``frames`` (B,enc_seq,D) for
audio (stub frame embeddings).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch.config import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import encdec, transformer

__all__ = ["TensorSpec", "init_params", "param_specs", "param_shapes",
           "extra_embeds_of", "forward", "init_serve_state",
           "serve_decode_step"]


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """A tensor's shape and dtype, with no storage."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def init_params(key: Union[int, torch.Generator], cfg: ArchConfig, *,
                device=None):
    """Random params: ``key`` is a seed, drawn from a generator on
    ``device`` (``None``: the CUDA device), or a ``torch.Generator``,
    whose device they go to."""
    if isinstance(key, torch.Generator):
        resolve_device(key.device)
        gen = key
    else:
        gen = torch.Generator(device=resolve_device(device)).manual_seed(key)
    if cfg.family == "audio":
        return encdec.init_encdec(gen, cfg)
    return transformer.init_lm(gen, cfg)


@functools.lru_cache(maxsize=None)
def param_specs(cfg: ArchConfig):
    """``init_params``' tree as ``TensorSpec``s: run on fake tensors,
    which hold no memory.  Do not modify the returned tree: it is
    cached."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.train.optimizer import tree_map
    with FakeTensorMode(allow_non_fake_inputs=True):
        params = init_params(0, cfg, device="cpu")
    return tree_map(lambda t: TensorSpec(tuple(t.shape), t.dtype), params)


def param_shapes(cfg: ArchConfig):
    """The tree of ``cfg``'s whole param shapes (``torch.Size`` leaves;
    the sharding rules need the whole shapes: ``sharding.LMLayout``)."""
    from repro_torch.train.optimizer import tree_map
    return tree_map(lambda s: torch.Size(s.shape), param_specs(cfg))


def extra_embeds_of(cfg: ArchConfig, batch: Dict[str, Any]):
    """The embeddings a decoder-only family prepends: the vlm's patches."""
    if cfg.family == "vlm":
        return batch["patches"]
    return None


def forward(params, cfg: ArchConfig, batch: Dict[str, Any], *,
            remat: bool = True, impl: Optional[str] = None,
            scan_impl: Optional[str] = None):
    """Full-sequence forward -> (logits, aux_loss, n_prefix).  ``remat``
    recomputes each layer in the backward; ``impl`` selects K11 and K12,
    ``scan_impl`` K12 alone where given (``models.transformer``).  Under
    an active mesh (``sharding.use_mesh``) ``params`` are this rank's
    blocks and ``batch`` its rows (``sharding.LMLayout``)."""
    if cfg.family == "audio":
        logits = encdec.forward_encdec(params, cfg, batch["tokens"],
                                       batch["frames"], impl=impl,
                                       remat=remat)
        return logits, torch.zeros((), dtype=torch.float32,
                                   device=logits.device), 0
    return transformer.forward_lm(params, cfg, batch["tokens"],
                                  extra_embeds_of(cfg, batch), remat=remat,
                                  impl=impl, scan_impl=scan_impl)


# ------------------------------------------------------------------ serving

def init_serve_state(params, cfg: ArchConfig, batch: int, context_len: int,
                     *, memory: Optional[torch.Tensor] = None,
                     force_window: bool = False, device=None):
    """Decode caches; the audio family's also hold the cross K/V of the
    encoder ``memory``, which it needs.  ``force_window`` puts every
    attention layer of a decoder-only family on a ring cache of its
    window (``transformer.layer_windows``)."""
    if cfg.family == "audio":
        if memory is None:
            raise ValueError(f"{cfg.arch_id}: decoding needs the encoder "
                             "memory (memory=)")
        return encdec.init_decode_state(params, cfg, batch, context_len,
                                        memory)
    if device is None:
        device = params["embed"].device
    return transformer.init_decode_state(cfg, batch, context_len,
                                         force_window=force_window,
                                         device=device)


def serve_decode_step(params, cfg: ArchConfig, caches, cur_index: int,
                      token, *, force_window: bool = False,
                      impl: Optional[str] = None):
    """One decode step -> (logits (B,Vp), caches).  ``impl`` reaches the
    audio family's cross-attention (K11 on the card); a decoder-only
    step runs no kernel.  ``force_window`` as the caches were made."""
    if cfg.family == "audio":
        return encdec.decode_step(params, cfg, caches, cur_index, token,
                                  impl=impl)
    return transformer.decode_step(params, cfg, caches, cur_index, token,
                                   force_window=force_window)
