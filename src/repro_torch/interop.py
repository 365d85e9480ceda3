"""Carry the JAX package's state into the port (tests and tools feed
the reference's own keys, clusterings and SplitNN params through
these), and the port's params back out as numpy."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.config import resolve_device
from repro_torch.core.coreset import ClientClustering
from repro_torch.train.optimizer import tree_map


def key_from_jax(key: np.ndarray) -> np.ndarray:
    """A ``jax.random.PRNGKey`` as numpy uint32[2] -> the port's key."""
    key = np.asarray(key)
    if key.shape != (2,) or key.dtype != np.uint32:
        raise ValueError(f"expected a uint32[2] key, got {key.dtype}"
                         f"{list(key.shape)}")
    return key.copy()


def clustering_from_jax(assign: np.ndarray, sq_dist: np.ndarray,
                        weight: np.ndarray, centroids: np.ndarray,
                        device=None) -> ClientClustering:
    """A reference ``ClientClustering``'s arrays -> the port's, with the
    centroids on ``device``."""
    return ClientClustering(
        np.asarray(assign, np.int32), np.asarray(sq_dist, np.float32),
        np.asarray(weight, np.float32),
        torch.as_tensor(np.array(centroids, np.float32),
                        device=resolve_device(device)))


def params_from_jax(params, device=None):
    """A tree (nested dicts/lists) of the reference's numpy or JAX
    arrays -> the same tree of f32 tensors on ``device``: the SplitNN zoo
    params (``{"bottoms": [...], "top": {...}}``) or, as
    ``lm_params_from_jax``, an LM's."""
    dev = resolve_device(device)
    return tree_map(lambda a: torch.as_tensor(np.array(a, np.float32),
                                              device=dev), params)


def params_to_numpy(params):
    """The port's params -> the same tree of float32 numpy arrays."""
    return tree_map(lambda t: t.detach().cpu().numpy(), params)


#: an LLM's params as the reference lays them out, as the same tree of
#: f32 tensors in the same layout (the conversion ``params_from_jax``
#: makes; f32 in every config): ``init_lm``'s (``embed``, stacked
#: ``layers`` with a leading L axis, ``final_norm``, ``lm_head``; GQA
#: weights (d, H, Dh), ``lm_head`` (d, Vp)), with the moe layers'
#: ``moe`` (``router`` (d, E), expert slabs (E, d, F) and (E, F, d)), the
#: hybrid layers' ``mamba`` and norms and ``meta_tokens`` (M, d), the
#: vlm's ``vision_proj`` (d, d); and ``init_encdec``'s (``embed``,
#: ``dec_pos_embed``, stacked ``enc_layers``/``dec_layers`` with
#: LayerNorm ``scale``/``bias``, ``enc_final_norm``, ``dec_final_norm``)
lm_params_from_jax = params_from_jax
