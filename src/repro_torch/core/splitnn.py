"""SplitNN configuration and the VFL k-NN: the part of
``repro.core.splitnn`` that the k-NN pipeline runs.

k-NN is distributed distance aggregation: ‖x−z‖² = Σ_m ‖x^m−z^m‖²
decomposes per client, so every client contributes its local partial
Gram/norm terms (plain f32 GEMMs on the device, outside any kernel, as
the reference leaves them to XLA) and the label owner votes.  The
SplitNN training zoo (lr/mlp/linreg) comes with the training slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.config import resolve_device
from repro_torch.data.vertical import VerticalPartition

__all__ = ["SplitNNConfig", "TrainReport", "knn_predict"]


@dataclasses.dataclass(frozen=True)
class SplitNNConfig:
    model: str                  # "lr" | "mlp" | "linreg" | "knn"
    n_classes: int              # 0 => regression
    bottom_dim: int = 8         # per-client intermediate width
    hidden_dim: int = 64        # top-model hidden width (mlp)
    lr: float = 0.01
    batch_size: int = 64
    max_epochs: int = 200
    convergence_eps: float = 1e-4   # paper: loss change over 5 epochs < 1e-4
    convergence_window: int = 5
    seed: int = 0


@dataclasses.dataclass
class TrainReport:
    """The training stage's report (``repro.train.vfl.TrainReport``);
    the k-NN stage fills it with zero epochs and steps."""
    losses: List[float]
    epochs: int
    steps: int
    train_seconds: float
    comm_bytes: int
    simulated_comm_seconds: float
    params: Any
    engine_stats: Any = None


def _sortable(d: torch.Tensor) -> torch.Tensor:
    """f32 -> int64 keys in the same order (negatives flip their
    magnitude bits; -0.0 sorts before +0.0, as a total order)."""
    bits = d.contiguous().view(torch.int32).to(torch.int64)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def _knn_neighbors(test_feats: Sequence[torch.Tensor],
                   train_feats: Sequence[torch.Tensor],
                   train_sq: torch.Tensor, kk: int) -> torch.Tensor:
    """Top-k nearest training rows for one test batch, on the device,
    nearest first.  Ties break to the lower training index, as
    ``lax.top_k`` does: ``topk`` runs on the unique int64 keys
    (sortable distance << 32) | index, because CUDA's ``topk`` promises
    no order among equal values."""
    a_sq = sum((a * a).sum(1) for a in test_feats)                  # (B,)
    cross = sum(a @ b.T for a, b in zip(test_feats, train_feats))   # (B,Ntr)
    d = a_sq[:, None] - 2.0 * cross + train_sq[None]
    idx = torch.arange(d.shape[1], device=d.device, dtype=torch.int64)
    keys = _sortable(d) * (2 ** 32) + idx[None]
    return torch.topk(keys, kk, dim=1, largest=False).values & 0xFFFFFFFF


def knn_predict(train_part: VerticalPartition, test_part: VerticalPartition,
                k: int = 5, *, sample_weights: Optional[np.ndarray] = None,
                batch: int = 512, device=None) -> np.ndarray:
    """VFL k-NN: clients contribute local partial distances (on the
    device), the label owner votes — optionally weighted by the coreset
    weights — with one vectorized scatter-add (``np.add.at`` over the
    (rows, k) neighbour grid, nearest neighbour first, as the
    reference)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False   # f32 means f32
    n_tr = train_part.n_samples
    n_te = test_part.n_samples
    w = (np.asarray(sample_weights, np.float64)
         if sample_weights is not None else np.ones(n_tr))
    labels = train_part.labels.astype(np.int64)
    n_classes = int(labels.max()) + 1
    kk = min(k, n_tr)
    to_dev = lambda f: torch.as_tensor(np.asarray(f, np.float32), device=dev)
    train_feats = [to_dev(f) for f in train_part.client_features]
    test_feats = [to_dev(f) for f in test_part.client_features]
    train_sq = sum((b * b).sum(1) for b in train_feats)
    nn = torch.cat([_knn_neighbors([f[s:s + batch] for f in test_feats],
                                   train_feats, train_sq, kk)
                    for s in range(0, n_te, batch)]).cpu().numpy()
    votes = np.zeros((n_te, n_classes))
    rows = np.broadcast_to(np.arange(n_te)[:, None], nn.shape)
    np.add.at(votes, (rows, labels[nn]), w[nn])
    return votes.argmax(axis=1)
