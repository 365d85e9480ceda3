"""Carry the JAX package's state into the port (tests and tools feed
the reference's own keys and clusterings through these)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.config import resolve_device
from repro_torch.core.coreset import ClientClustering


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
