"""Synthetic datasets shaped like the paper's six evaluation datasets.

Table 1 of the paper:

  Dataset      BA    MU    RI    HI     BP    YP
  #instances   10K   8K    18K   100K   13K   510K
  #features    11    22    11    32     11    90
  #classes     2     2     2     2      4     regression

We have no network access, so we generate class-structured Gaussian-mixture
data with the same (N, d, classes) signature. Each class (or latent "mode"
for regression) is a mixture of a few anisotropic Gaussian clusters, which
gives K-Means-selectable structure — the property Cluster-Coreset exploits —
while remaining non-trivially separable (controlled class margin).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    n_instances: int
    n_features: int
    n_classes: int          # 0 => regression
    modes_per_class: int = 3
    margin: float = 2.2     # inter-class centroid separation scale
    noise: float = 1.0


DATASETS: Dict[str, DatasetSpec] = {
    "BA": DatasetSpec("BA", 10_000, 11, 2),
    "MU": DatasetSpec("MU", 8_000, 22, 2),
    "RI": DatasetSpec("RI", 18_000, 11, 2, modes_per_class=2, margin=3.5),
    "HI": DatasetSpec("HI", 100_000, 32, 2),
    "BP": DatasetSpec("BP", 13_000, 11, 4),
    "YP": DatasetSpec("YP", 510_000, 90, 0),
}


def make_dataset(spec: DatasetSpec, *, seed: int = 0,
                 n_override: Optional[int] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (X (N,d) f32, y (N,) int64 or f32-regression)."""
    rng = np.random.default_rng(seed)
    n = n_override or spec.n_instances
    d = spec.n_features
    if spec.n_classes == 0:
        # regression: y = sparse-linear(x) through a few latent modes
        k = spec.modes_per_class * 4
        centers = rng.normal(0, spec.margin, (k, d))
        assign = rng.integers(0, k, n)
        x = centers[assign] + rng.normal(0, spec.noise, (n, d))
        w_true = rng.normal(0, 1, (d,)) * (rng.random(d) < 0.4)
        y = x @ w_true + 0.1 * rng.normal(0, 1, n)
        # normalize target to ~[0, 100] like YearPredictionMSD years
        y = 50 + 15 * (y - y.mean()) / (y.std() + 1e-9)
        return x.astype(np.float32), y.astype(np.float32)
    k = spec.n_classes * spec.modes_per_class
    centers = rng.normal(0, spec.margin, (k, d))
    mode_class = np.repeat(np.arange(spec.n_classes), spec.modes_per_class)
    assign = rng.integers(0, k, n)
    x = centers[assign] + rng.normal(0, spec.noise, (n, d))
    y = mode_class[assign]
    return x.astype(np.float32), y.astype(np.int64)


def make_id_universe(n_clients: int, n_per_client, overlap: float = 0.7, *,
                     seed: int = 0):
    """Per-client sample-ID sets with a common core (paper §5.3: 70% overlap).

    ``n_per_client`` is an int (uniform) or list of ints (volume-skewed,
    Fig. 7(c)). Returns (list of np.ndarray id-sets, core_ids).
    IDs are randomly shuffled per client, mimicking per-institution orderings.
    """
    rng = np.random.default_rng(seed)
    if isinstance(n_per_client, int):
        n_per_client = [n_per_client] * n_clients
    assert len(n_per_client) == n_clients
    n_core = int(round(min(n_per_client) * overlap))
    # a universe comfortably larger than all sets so non-core ids are distinct
    universe = rng.permutation(int(sum(n_per_client) * 2 + n_core))
    core = universe[:n_core]
    cursor = n_core
    sets = []
    for n in n_per_client:
        extra = universe[cursor:cursor + (n - n_core)]
        cursor += n - n_core
        ids = np.concatenate([core, extra])
        sets.append(rng.permutation(ids))
    return sets, np.sort(core)
