"""Vertical feature partitioning — each client holds a disjoint feature slice
of every sample (the defining property of VFL).

The paper's protocol (§5.1): "The dataset is equally partitioned into three
portions, and each portion is held by one client," with the label owner
holding all labels.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class VerticalPartition:
    """Feature slices per client + the label owner's labels."""
    client_features: List[np.ndarray]   # m arrays of (N, d_m)
    labels: np.ndarray                  # (N,)
    feature_slices: List[slice]

    @property
    def n_clients(self) -> int:
        return len(self.client_features)

    @property
    def n_samples(self) -> int:
        return self.labels.shape[0]

    def take(self, indices: np.ndarray) -> "VerticalPartition":
        return VerticalPartition(
            [f[indices] for f in self.client_features],
            self.labels[indices], self.feature_slices)


def partition_features(x: np.ndarray, y: np.ndarray, n_clients: int, *,
                       proportions: Optional[Sequence[float]] = None
                       ) -> VerticalPartition:
    """Split feature columns across clients (equal by default)."""
    d = x.shape[1]
    if proportions is None:
        sizes = [d // n_clients] * n_clients
        for i in range(d % n_clients):
            sizes[i] += 1
    else:
        assert len(proportions) == n_clients
        total = sum(proportions)
        sizes = [max(1, int(round(d * p / total))) for p in proportions]
        sizes[-1] = d - sum(sizes[:-1])
    slices, start = [], 0
    for s in sizes:
        slices.append(slice(start, start + s))
        start += s
    return VerticalPartition(
        [x[:, sl].copy() for sl in slices], y.copy(), slices)
