"""SplitNN VFL model zoo (paper §3) with instance-wise communication
accounting, and the VFL k-NN: the port of ``repro.core.splitnn``.

Roles: M clients (bottom models f_b^m over local feature slices), an
aggregation server (top model f_t), and the label owner (loss).  Per
step: ① clients run bottoms on their slices → activations, ② the server
concatenates them and runs the top model, ③ the label owner computes
the (optionally Eq.2-weighted) loss, ④ the server backprops and returns
per-client bottom grads.  On the device this is one partitioned
forward/backward; the VFL structure shows up as the block-diagonal
bottom layer (one slab pass, ``kernels/splitnn_bottom``) and as the
counted activation/gradient bytes per sample per step.

Training lives in ``repro_torch.train.vfl`` (the epoch engine and the
per-step loop oracle); ``train_splitnn`` is the stage entry point the
pipeline calls, and ``predict``/``evaluate`` score through
``repro_torch.serve.vfl.score_partition``.

k-NN is distributed distance aggregation: ‖x−z‖² = Σ_m ‖x^m−z^m‖²
decomposes per client, so every client contributes its local partial
Gram/norm terms (plain f32 GEMMs on the device, outside any kernel, as
the reference leaves them to XLA) and the label owner votes.

Params are the reference's tree, with tensors for arrays:
``{"bottoms": [{"w": (d_m, o)[, "b": (o,)]}, ...], "top": {...}}``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import rng
from repro_torch.config import EngineOptions, resolve_device
from repro_torch.data.vertical import VerticalPartition
from repro_torch.quant import resolve_quant, wire_bytes
from repro_torch.train.losses import (weighted_binary_xent, weighted_mse,
                                      weighted_softmax_xent)
from repro_torch.train.vfl import EngineStats, TrainReport  # re-export

ACT_BYTES = 4  # f32 activation/gradient element on the wire

__all__ = [
    "ACT_BYTES", "SplitNNConfig", "TrainReport", "EngineStats",
    "init_splitnn", "splitnn_forward", "activation_width",
    "activation_bytes_per_sample", "train_splitnn", "predict", "evaluate",
    "knn_predict",
]


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


# ----------------------------------------------------------------- modeling

def init_splitnn(cfg: SplitNNConfig, feature_dims: Sequence[int], *,
                 device=None):
    """The reference's initial params, drawn with the port's threefry
    (``rng.normal``, within a few ulps of ``jax.random.normal``) in
    numpy float32, then placed on ``device``."""
    dev = resolve_device(device)
    f32 = np.float32
    ks = rng.split(rng.PRNGKey(cfg.seed), len(feature_dims) + 2)
    m = len(feature_dims)
    t = lambda a: torch.as_tensor(np.asarray(a, f32), device=dev)
    zeros = lambda n: torch.zeros((n,), dtype=torch.float32, device=dev)
    if cfg.model in ("lr", "linreg"):
        # bottoms are the local linear partial sums; top is sum + bias
        n_out = (1 if cfg.model == "linreg" or cfg.n_classes == 2
                 else max(cfg.n_classes, 1))
        bottoms = [{"w": t(rng.normal(ks[i], (d, n_out)) * f32(d ** -0.5)
                           * f32(0.1))}
                   for i, d in enumerate(feature_dims)]
        return {"bottoms": bottoms, "top": {"b": zeros(n_out)}}
    if cfg.model == "mlp":
        n_out = cfg.n_classes if cfg.n_classes > 2 else 1
        bd, hd = cfg.bottom_dim, cfg.hidden_dim
        bottoms = [{"w": t(rng.normal(ks[i], (d, bd)) * f32(d ** -0.5)),
                    "b": zeros(bd)} for i, d in enumerate(feature_dims)]
        top = {"w1": t(rng.normal(ks[m], (m * bd, hd))
                       * f32((m * bd) ** -0.5)),
               "b1": zeros(hd),
               "w2": t(rng.normal(ks[m + 1], (hd, n_out)) * f32(hd ** -0.5)),
               "b2": zeros(n_out)}
        return {"bottoms": bottoms, "top": top}
    raise ValueError(cfg.model)


def splitnn_forward(params, cfg: SplitNNConfig,
                    xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """xs: per-client feature slices [(B, d_m)] -> outputs (B, o).  The
    per-client loop form; the slab form is
    ``repro_torch.train.vfl.forward_slab_packed``."""
    acts = []
    for bp, x in zip(params["bottoms"], xs):
        a = x @ bp["w"]
        if "b" in bp:
            a = torch.relu(a + bp["b"])
        acts.append(a)
    if cfg.model in ("lr", "linreg"):
        return sum(acts) + params["top"]["b"]
    h = torch.cat(acts, dim=1)
    h = torch.relu(h @ params["top"]["w1"] + params["top"]["b1"])
    return h @ params["top"]["w2"] + params["top"]["b2"]


def _loss_from_out(out: torch.Tensor, cfg: SplitNNConfig, y: torch.Tensor,
                   w: Optional[torch.Tensor]) -> torch.Tensor:
    """Eq.(2) weighted loss from model output (shared by both engines)."""
    if cfg.n_classes == 0:
        return weighted_mse(out[:, 0:1], y[:, None], w)
    if cfg.n_classes == 2 and out.shape[-1] == 1:
        return weighted_binary_xent(out[:, 0], y, w)
    return weighted_softmax_xent(out, y, w)


def _loss_fn(params, cfg: SplitNNConfig, xs, y, w) -> torch.Tensor:
    return _loss_from_out(splitnn_forward(params, cfg, xs), cfg, y, w)


def activation_width(cfg: SplitNNConfig) -> int:
    """Per-client activation elements per sample on the wire."""
    if cfg.model in ("lr", "linreg"):
        return 1 if cfg.n_classes in (0, 2) else cfg.n_classes
    return cfg.bottom_dim


def activation_bytes_per_sample(cfg: SplitNNConfig, m_clients: int,
                                quant: Optional[str] = None) -> int:
    """Instance-wise communication per sample per step (forward
    activation in the wire dtype + f32 backward gradient)."""
    return (wire_bytes(quant) + ACT_BYTES) * activation_width(cfg) * m_clients


# ------------------------------------------------------------------ training

def train_splitnn(partition: VerticalPartition, cfg: SplitNNConfig, *,
                  sample_weights: Optional[np.ndarray] = None,
                  bandwidth: float = 10e9 / 8, latency: float = 2e-4,
                  verbose: bool = False,
                  options: Optional[EngineOptions] = None) -> TrainReport:
    """Mini-batch Adam training to the paper's convergence criterion.

    ``options.train_engine="scan"`` (default): the epoch engine, one
    host sync per epoch, ``bottom_impl`` picking the CUDA kernels
    ("kernel"), their plain versions ("ref") or per-client GEMMs
    ("loop"), ``fuse_gather`` fusing the step's row gather into the
    bottom pass, ``mesh``/``shard_axis`` sharding it (``train.vfl``).
    ``"loop"``: the per-minibatch host loop (the parity oracle, one
    sync per step; f32 only, unsharded: a mesh raises).  ``options.quant``
    ("int8"|"fp8", DESIGN.md §12) quantizes the per-step activation send
    (and, for int8, the bottom GEMM) to a 1-byte wire dtype with pow2
    block scales."""
    from repro_torch.train import vfl

    options = options or EngineOptions()
    if options.train_engine == "loop":
        if options.mesh is not None:
            raise ValueError("engine='loop' does not shard; use the scan "
                             "engine for mesh training")
        if resolve_quant(options.quant) is not None:
            raise ValueError("engine='loop' communicates f32 only; use the "
                             "scan engine for quantized training")
        return vfl.train_loop(partition, cfg, sample_weights=sample_weights,
                              bandwidth=bandwidth, latency=latency,
                              verbose=verbose, device=options.device)
    if options.train_engine != "scan":
        raise ValueError(options.train_engine)
    return vfl.train_scan(partition, cfg, sample_weights=sample_weights,
                          bandwidth=bandwidth, latency=latency,
                          options=options, verbose=verbose)


# ---------------------------------------------------------------- evaluation

def predict(params, cfg: SplitNNConfig, partition: VerticalPartition, *,
            block_b: int = 512, bottom_impl: Optional[str] = None,
            quant: Optional[str] = None) -> np.ndarray:
    """Batched prediction through the serving score path
    (``score_partition``: ``block_b``-row slab batches through K1, or K9
    under int8).  ``quant`` applies the wire rounding quantized training
    saw, so a quantized model evaluates under its training numerics."""
    from repro_torch.serve.vfl import score_partition

    out = score_partition(params, cfg, partition, block_b=block_b,
                          bottom_impl=bottom_impl, quant=quant)
    if cfg.n_classes == 0:
        return out[:, 0]
    if cfg.n_classes == 2 and out.shape[-1] == 1:
        return (out[:, 0] > 0).astype(np.int64)
    return out.argmax(axis=1)


def evaluate(params, cfg: SplitNNConfig, partition: VerticalPartition, *,
             block_b: int = 512, bottom_impl: Optional[str] = None,
             quant: Optional[str] = None) -> float:
    """Accuracy for classification, MSE for regression."""
    pred = predict(params, cfg, partition, block_b=block_b,
                   bottom_impl=bottom_impl, quant=quant)
    if cfg.n_classes == 0:
        return float(np.mean((pred - partition.labels) ** 2))
    return float(np.mean(pred == partition.labels))


# --------------------------------------------------------------- VFL k-NN

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
