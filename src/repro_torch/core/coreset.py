"""Cluster-Coreset (paper §4.2): the port of ``repro.core.coreset``.

Five steps, as the paper and the reference:
  1. Local clustering    — each client K-Means its local feature slice.
  2. Weight computation  — w_i^m = pos(ed_i, DeSort({ed_j})) / |S_c|.
  3. CT construction     — clients ship HE-encrypted (w_i^m, c_i^m, ed_i^m)
                           per sample via the aggregation server.
  4. Data selection      — group by (CT, label); keep argmin_i Σ_m ed_i^m.
  5. Sample weighting    — coreset weight w_i = Σ_m w_i^m.

Step 1 runs on the device: all M clients in one zero-padded
(M, N_max, d_max) stack, one launch of the fused Lloyd kernel per
iteration (``core/kmeans.kmeans_fit``).  Steps 2-5 are host numpy at
the label owner, copied from the reference.  Per-client keys follow the
reference's ``PRNGKey(seed + 17*m)``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import rng
from repro_torch.config import resolve_device, resolve_impl
from repro_torch.core import he
from repro_torch.core.kmeans import kmeans_fit
from repro_torch.data.vertical import VerticalPartition
from repro_torch.kernels.padding import stack_padded
from repro_torch.obs.trace import span


@dataclasses.dataclass
class ClientClustering:
    """Step 1+2 output for one client: host arrays for the label owner's
    selection, the centroids on the device."""
    assign: np.ndarray        # (N,) int32 cluster index c_i^m
    sq_dist: np.ndarray       # (N,) f32  squared distance
    weight: np.ndarray        # (N,) f32  local weight w_i^m
    centroids: torch.Tensor   # (k, d_m) f32


@dataclasses.dataclass
class CoresetResult:
    indices: np.ndarray       # [N_core] indices into the aligned samples
    weights: np.ndarray       # (N_core,) f32 — Σ_m w_i^m
    n_groups: int             # distinct (CT, label) groups
    comm_bytes: int           # step-3/4 traffic through the server
    he_seconds: float         # measured encryption time (0 if use_he=False)
    local: List[ClientClustering]
    # steps 1-2 run CONCURRENTLY on the clients in a real deployment —
    # the stage cost is the max over clients, not the host-measured sum
    per_client_seconds: List[float] = dataclasses.field(default_factory=list)
    select_seconds: float = 0.0
    batched: bool = False     # clients fit in one batched device call

    @property
    def makespan_seconds(self) -> float:
        return (max(self.per_client_seconds, default=0.0)
                + self.select_seconds + self.he_seconds)


def rank_weights(assign: np.ndarray, sq_dist: np.ndarray,
                 k: int) -> np.ndarray:
    """Step-2 weights: w_i = pos(ed_i, DeSort({ed_j})) / |S_c| — the
    closest sample of a cluster gets weight 1, the farthest 1/|S_c|;
    ties break by original index (stable lexsort)."""
    n = assign.shape[0]
    if n == 0:
        return np.zeros(0, np.float32)
    ed = np.sqrt(np.maximum(sq_dist, 0.0))
    # primary key: cluster; secondary: descending distance (stable ties)
    order = np.lexsort((-ed, assign))
    sizes = np.bincount(assign, minlength=k)
    starts = np.concatenate(([0], np.cumsum(sizes)[:-1]))
    sorted_assign = assign[order]
    pos = np.arange(1, n + 1) - starts[sorted_assign]      # 1-based in-group
    weight = np.zeros(n, np.float64)
    weight[order] = pos / sizes[sorted_assign]
    return weight.astype(np.float32)


def select_coreset(local: Sequence[ClientClustering], labels: np.ndarray, *,
                   regression_bins: int = 16) -> Tuple[np.ndarray, np.ndarray,
                                                       int]:
    """Steps 4-5 at the label owner. Returns (indices, weights, n_groups).

    Regression labels (float) are quantile-binned so "split S_ct^j by
    label" stays meaningful."""
    cts = np.stack([c.assign for c in local], axis=1)          # (N, M)
    ed = np.stack([np.sqrt(np.maximum(c.sq_dist, 0.0)) for c in local],
                  axis=1)                                      # (N, M)
    w = np.stack([c.weight for c in local], axis=1)            # (N, M)

    if np.issubdtype(labels.dtype, np.floating):
        qs = np.quantile(labels, np.linspace(0, 1, regression_bins + 1)[1:-1])
        lab = np.searchsorted(qs, labels).astype(np.int64)
    else:
        lab = labels.astype(np.int64)

    keys = np.concatenate([cts, lab[:, None]], axis=1)         # (N, M+1)
    _, group_ids = np.unique(keys, axis=0, return_inverse=True)
    group_ids = group_ids.reshape(-1)
    agg_ed = ed.sum(axis=1)

    n_groups = int(group_ids.max()) + 1 if group_ids.size else 0
    # argmin aggregated distance per group
    order = np.lexsort((agg_ed, group_ids))
    first = np.ones(len(order), bool)
    first[1:] = group_ids[order][1:] != group_ids[order][:-1]
    chosen = np.sort(order[first])
    weights = w[chosen].sum(axis=1)
    return chosen.astype(np.int64), weights.astype(np.float32), n_groups


def _he_exchange_cost(local: Sequence[ClientClustering], n: int,
                      use_he: bool) -> Tuple[int, float]:
    """Step-3 transport: one packed ciphertext (w, c, ed) per sample per
    client, plus the encrypted selected-indicator broadcast."""
    m = len(local)
    if not use_he:
        return n * m * 3 * 8, 0.0
    pk, sk = he.keygen(256, seed=11)
    t0 = time.perf_counter()
    n_sample = min(n, 64)
    for cl in local:
        for i in range(n_sample):
            c = he.encrypt_tuple(pk, [float(cl.weight[i]),
                                      float(cl.assign[i]),
                                      float(np.sqrt(max(cl.sq_dist[i], 0)))])
    t = time.perf_counter() - t0
    # verified-sample decrypt round trip (fidelity check)
    he.decrypt_tuple(sk, c, 3)
    est = t * (n / max(n_sample, 1))
    return n * m * pk.ciphertext_bytes(), est


def clients_batchable(features: Sequence[np.ndarray], *,
                      clusters: Optional[int] = None) -> bool:
    """True when steps 1-2 run as one batched fit: same-shape clients
    always, ragged clients unless some client has fewer samples than
    ``clusters`` (it would need its own smaller k), as the reference."""
    feats = list(features)
    if len(feats) <= 1:
        return False
    if len({f.shape for f in feats}) == 1:
        return True
    min_n = min(f.shape[0] for f in feats)
    return min_n >= 1 and (clusters is None or min_n >= clusters)


def _fit_clients(features: Sequence[np.ndarray], k: int, seeds: Sequence[int],
                 *, iters: int, impl: str, device: torch.device
                 ) -> List[ClientClustering]:
    """Steps 1-2 for a group of clients in ONE batched fit: the slices
    zero-pad to (M, N_max, d_max) (zero columns are exact, zero rows are
    masked through ``n_valid``), k is shared (min over the group), and
    each client's outputs slice back to its true (N_m, d_m)."""
    ns = [int(f.shape[0]) for f in features]
    ds = [int(f.shape[1]) for f in features]
    k_eff = int(min(k, min(ns)))
    keys = np.stack([rng.PRNGKey(s) for s in seeds])
    stacked = stack_padded([torch.as_tensor(np.asarray(f, np.float32),
                                            device=device)
                            for f in features], max(ns), max(ds))
    cents, assign, sqd = kmeans_fit(keys, stacked, k_eff, iters=iters,
                                    impl=impl, n_valid=ns)
    assign = assign.cpu().numpy()
    sqd = sqd.cpu().numpy()
    return [ClientClustering(assign[i, :ns[i]],
                             sqd[i, :ns[i]],
                             rank_weights(assign[i, :ns[i]], sqd[i, :ns[i]],
                                          k_eff),
                             cents[i, :, :ds[i]])
            for i in range(len(features))]


def cluster_coreset(partition: VerticalPartition, clusters_per_client: int, *,
                    seed: int = 0, kmeans_iters: int = 25,
                    kmeans_impl: Optional[str] = None, use_he: bool = False,
                    device=None) -> CoresetResult:
    """Full Cluster-Coreset over a vertical partition.

    All clients fit in one batched device call when
    ``clients_batchable`` allows it; its wall time / M stands for ONE
    client's concurrent compute in ``per_client_seconds`` (the
    max-over-clients makespan model).  Otherwise each client fits alone,
    with its own k = min(k, N_m)."""
    dev = resolve_device(device)
    impl = resolve_impl(kmeans_impl, dev)
    feats = list(partition.client_features)
    m = len(feats)
    batched = clients_batchable(feats, clusters=clusters_per_client)
    with span("coreset.fit", clients=m, batched=batched,
              k=clusters_per_client):
        if batched:
            t0 = time.perf_counter()
            local = _fit_clients(feats, clusters_per_client,
                                 [seed + 17 * i for i in range(m)],
                                 iters=kmeans_iters, impl=impl, device=dev)
            per_client = [(time.perf_counter() - t0) / m] * m
        else:
            local, per_client = [], []
            for i, f in enumerate(feats):
                t0 = time.perf_counter()
                local += _fit_clients([f], clusters_per_client,
                                      [seed + 17 * i], iters=kmeans_iters,
                                      impl=impl, device=dev)
                per_client.append(time.perf_counter() - t0)
    sel_sp = span("coreset.select", rows=partition.n_samples)
    with sel_sp:
        t0 = time.perf_counter()
        idx, w, n_groups = select_coreset(local, partition.labels)
        select_secs = time.perf_counter() - t0
    sel_sp.set(n_coreset=int(idx.shape[0]), n_groups=n_groups)
    he_sp = span("coreset.he", use_he=use_he, clients=m)
    with he_sp:
        comm, he_secs = _he_exchange_cost(local, partition.n_samples, use_he)
    he_sp.set(comm_bytes=comm)
    return CoresetResult(indices=idx, weights=w, n_groups=n_groups,
                         comm_bytes=comm, he_seconds=he_secs, local=local,
                         per_client_seconds=per_client,
                         select_seconds=select_secs, batched=batched)
