"""The paper's Table-2 jobs and their datasets, as the port runs them.

Numpy copies of what the jobs take from outside the JAX package:
``benchmarks/common.py`` (``QUICK_N``, ``dataset_partitions``: the
paper's 70/30 split, features equally over the clients, labels at the
label owner) and ``benchmarks/table2_framework.py`` (``JOBS``,
``VARIANTS`` and the ``SplitNNConfig`` that ``run``/``run_e2e`` build
for a job).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from repro_torch.core.splitnn import SplitNNConfig
from repro_torch.data.synthetic import DATASETS, make_dataset
from repro_torch.data.vertical import VerticalPartition, partition_features

# CPU-budget dataset scale: the paper's sizes divided by ~10
QUICK_N = {"BA": 2000, "MU": 1600, "RI": 3000, "HI": 4000, "BP": 2600,
           "YP": 4000}

# dataset → (model, n_classes, lr, clusters/client) per the paper's Table 2
JOBS = [
    ("BA", "lr", 2, 0.05, 12),
    ("BA", "mlp", 2, 0.01, 12),
    ("MU", "lr", 2, 0.05, 10),
    ("MU", "mlp", 2, 0.01, 10),
    ("RI", "lr", 2, 0.05, 8),
    ("RI", "mlp", 2, 0.01, 8),
    ("RI", "knn", 2, 0.0, 8),
    ("HI", "lr", 2, 0.05, 14),
    ("HI", "mlp", 2, 0.01, 14),
    ("HI", "knn", 2, 0.0, 14),
    ("BP", "mlp", 4, 0.01, 12),
    ("YP", "linreg", 0, 0.05, 12),
]

VARIANTS = ("starall", "treeall", "starcss", "treecss")


def dataset_partitions(name: str, *, n_clients: int = 3, seed: int = 0,
                       quick: bool = True, n_override: Optional[int] = None
                       ) -> Tuple[VerticalPartition, VerticalPartition]:
    """Paper protocol: 70/30 train/test split, features equally over
    ``n_clients`` clients, labels at the label owner.  ``n_override``
    forces the instance count; ``quick`` takes ``QUICK_N``, else the
    paper's size."""
    spec = DATASETS[name]
    n = n_override or (QUICK_N[name] if quick else spec.n_instances)
    x, y = make_dataset(spec, seed=seed, n_override=n)
    order = np.random.default_rng(seed + 1).permutation(n)
    n_tr = int(n * 0.7)
    tr = partition_features(x[order[:n_tr]], y[order[:n_tr]], n_clients)
    te = partition_features(x[order[n_tr:]], y[order[n_tr:]], n_clients)
    return tr, te


def table2_config(model: str, n_classes: int, lr: float, n_train_rows: int,
                  max_epochs: int, seed: int = 0) -> SplitNNConfig:
    """The ``SplitNNConfig`` of a Table-2 job: ``lr or 0.01`` (k-NN's 0)
    and batches of ``max(8, n_train_rows // 100)`` rows."""
    return SplitNNConfig(model=model, n_classes=n_classes, lr=lr or 0.01,
                         batch_size=max(8, n_train_rows // 100),
                         max_epochs=max_epochs, seed=seed)
