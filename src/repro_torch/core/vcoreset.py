"""V-coreset baseline [Huang et al., NeurIPS 2022] — the comparison of Fig. 6.

V-coreset builds coresets for VERTICAL federated *regularized linear
regression* via leverage-score (sensitivity) sampling over per-client
orthonormal bases, and for k-means via local sensitivities. We implement
the linear-regression construction faithfully:

  · each client computes an orthonormal basis U_m of its local feature
    block (thin SVD),
  · the server concatenates projections — leverage of sample i is
    ℓ_i = Σ_m ‖U_m[i]‖² (+ label-row leverage for the regression target),
  · the coreset samples i with probability p_i ∝ ℓ_i and weights 1/(T·p_i).

As the paper notes, this (a) ships raw projections (label/feature leakage —
V-coreset's privacy flaw) and (b) is model-specific; we reuse the same
sampler for classification comparisons exactly like the paper's Fig. 6 does.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.data.vertical import VerticalPartition


def leverage_scores(partition: VerticalPartition, *,
                    include_labels: bool = True) -> np.ndarray:
    n = partition.n_samples
    lev = np.zeros(n, np.float64)
    for f in partition.client_features:
        x = np.asarray(f, np.float64)
        x = x - x.mean(axis=0, keepdims=True)
        u, s, _ = np.linalg.svd(x, full_matrices=False)
        rank = int(np.sum(s > s.max() * 1e-9)) if s.size else 0
        lev += np.sum(u[:, :rank] ** 2, axis=1)
    if include_labels:
        y = np.asarray(partition.labels, np.float64).reshape(n, -1)
        y = y - y.mean(axis=0, keepdims=True)
        ny = np.linalg.norm(y)
        if ny > 0:
            lev += np.sum((y / ny) ** 2, axis=1)
    return lev


def vcoreset(partition: VerticalPartition, size: int, *, seed: int = 0
             ) -> Tuple[np.ndarray, np.ndarray]:
    """Importance-sample ``size`` rows by leverage. Returns (idx, weights).

    Sampling is WITH replacement, as in Huang et al.: the ``1/(T·p_i)``
    sensitivity weights are the with-replacement estimator, and
    replacement keeps the draw well-defined when fewer than ``size``
    leverage scores are nonzero (rank-deficient feature blocks zero out
    most of ``p``, which made ``replace=False`` raise).  Duplicate draws
    dedup afterwards by accumulating their weight (c_i draws of row i
    weigh ``c_i/(T·p_i)``), so the returned index set is unique/sorted —
    possibly smaller than ``size``, matching the multiset's total mass.
    """
    rng = np.random.default_rng(seed)
    lev = leverage_scores(partition)
    n = partition.n_samples
    # clamp fp-negative scores and renormalize; a degenerate all-zero /
    # non-finite vector falls back to uniform sampling
    lev = np.where(np.isfinite(lev), np.maximum(lev, 0.0), 0.0)
    total = lev.sum()
    p = lev / total if total > 0 else np.full(n, 1.0 / n)
    p = p / p.sum()
    size = min(size, n)
    draws = rng.choice(n, size=size, replace=True, p=p)
    idx, counts = np.unique(draws, return_counts=True)   # sorted unique
    w = counts / (size * p[idx])
    w = w / w.mean()  # normalize scale for comparable LR tuning
    return idx.astype(np.int64), w.astype(np.float32)
