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
iteration (``core/kmeans.kmeans_fit``).  The beyond-paper mini-batch
fit (``kmeans_algo="minibatch"``) fits the clients one after another,
as the reference, one gather-fused update launch per Sculley step.
Steps 2-5 are host numpy at the label owner, with the reference's
values, ties and precision.  Their three sorts by composite keys (a
client's rows by cluster and distance, the rows' groups, each group's
least summed distance) sort one integer word a row where the key fits
one: a mixed-radix group code numbered through a dense table or a 1-D
``np.unique``, and 64-bit words of (major key, f32 distance bits, row)
under one ``np.sort``.  Each falls back to the reference's row-wise
``np.unique`` or ``lexsort`` where its word would not fit or a distance
is not finite; the spans record which form ran.
Per-client keys follow the reference's ``PRNGKey(seed + 17*m)``.

With a mesh (``cluster_coreset(mesh=, shard_axis=)``) the batched fit's
clients split over one mesh dim (``data`` by default;
``repro_torch.sharding``): M pads to a multiple of the dim's size with
client-0 filler, each rank fits its block of clients at the whole
batch's (N_max, d_max) and for the whole batch's client count (so every
client's sums run as in the unsharded fit), and the blocks' centroids,
assignments and distances are all-gathered; selection then runs on
every rank, byte-identical to the unsharded coreset.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import rng
from repro_torch.config import resolve_device, resolve_impl
from repro_torch.core import he
from repro_torch.core.kmeans import fit_client, kmeans_fit
from repro_torch.data.vertical import VerticalPartition
from repro_torch.kernels.padding import stack_padded
from repro_torch.obs.trace import span
from repro_torch.sharding import (MeshAxis, all_gather_rows, my_rows,
                                  resolve_batch_mesh)


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
    shards: int = 1           # mesh-dim size the client batch split over

    @property
    def makespan_seconds(self) -> float:
        return (max(self.per_client_seconds, default=0.0)
                + self.select_seconds + self.he_seconds)


#: bits of a finite f32 >= +0.0 read as uint32, which orders like its
#: value; so does 0x7FFFFFFF less it, descending
_F32_BITS = 31
#: a group code's dense table may hold this many entries a row, or
#: ``_DENSE_MIN`` whatever the row count
_DENSE_PER_ROW, _DENSE_MIN = 4, 1 << 16


def _bits(n: int) -> int:
    """Bits that hold 0 ... n - 1."""
    return max(n - 1, 0).bit_length()


def _sorted_rows(major: np.ndarray, major_bits: int, x: np.ndarray, *,
                 descending: bool = False) -> Tuple[np.ndarray, bool]:
    """The rows sorted by ``major`` (ints under 2**major_bits), then by
    ``x`` >= 0, ties by row: ``np.lexsort((±x, major))``'s order, and
    whether it came from packed words.  Where ``x`` is finite f32 and
    ``major << (31 + b) | bits(x) << b | row`` fits 64 bits (``b`` the
    bits of a row index; a descending ``x`` as 0x7FFFFFFF less its
    bits), one ``np.sort`` of those words gives it: the row makes every
    word unique, so the sort needs no stability."""
    n = major.shape[0]
    b = _bits(n)
    if (x.dtype != np.float32 or major_bits + _F32_BITS + b > 64
            or not np.isfinite(x).all()):
        return np.lexsort((-x if descending else x, major)), False
    bits = (x + np.float32(0)).view(np.uint32)           # -0.0 as +0.0
    if descending:
        bits = np.uint32(0x7FFFFFFF) - bits
    key = major.astype(np.uint64)
    key <<= np.uint64(_F32_BITS)
    key |= bits
    key <<= np.uint64(b)
    key |= np.arange(n, dtype=np.uint64)
    key.sort()
    key &= np.uint64((1 << b) - 1)
    return key.view(np.int64), True


def _rank_weights(assign: np.ndarray, sq_dist: np.ndarray,
                  k: int) -> Tuple[np.ndarray, bool]:
    """``rank_weights``, and whether its order came from packed words
    (else from ``lexsort``)."""
    n = assign.shape[0]
    if n == 0:
        return np.zeros(0, np.float32), False
    ed = np.sqrt(np.maximum(sq_dist, 0.0))
    sizes = np.bincount(assign, minlength=k)
    # by cluster, then by descending distance (stable ties)
    order, packed = _sorted_rows(assign, _bits(sizes.shape[0]), ed,
                                 descending=True)
    # the order runs cluster by cluster, so the sorted rows' clusters
    # are each cluster's index repeated its size
    starts = np.concatenate(([0], np.cumsum(sizes)[:-1]))
    pos = np.arange(1, n + 1) - np.repeat(starts, sizes)   # 1-based in-group
    weight = np.empty(n, np.float32)
    weight[order] = pos / np.repeat(sizes, sizes)
    return weight, packed


def rank_weights(assign: np.ndarray, sq_dist: np.ndarray,
                 k: int) -> np.ndarray:
    """Step-2 weights: w_i = pos(ed_i, DeSort({ed_j})) / |S_c| — the
    closest sample of a cluster gets weight 1, the farthest 1/|S_c|;
    ties break by original index (stable lexsort)."""
    return _rank_weights(assign, sq_dist, k)[0]


def _rows_group_ids(cols: Sequence[np.ndarray]) -> np.ndarray:
    """Each row's group: the rank of its key (``cols`` read left to
    right) among the distinct keys, from a row-wise ``np.unique``."""
    keys = np.stack([c.astype(np.int64) for c in cols], axis=1)
    _, group_ids = np.unique(keys, axis=0, return_inverse=True)
    return group_ids.reshape(-1)


def _group_ids(cols: Sequence[np.ndarray]) -> Tuple[np.ndarray, int, str]:
    """``_rows_group_ids``, the group count, and the tier that numbered
    them.  Each column shifted to start at 0 is one digit of a
    mixed-radix code that orders like the key; under 2**63 the code is
    numbered by a dense table of its values (``dense``, where the table
    is small next to the rows) or by ``np.unique`` of the 1-D code
    (``code``); past it, by rows (``rows``)."""
    n = cols[0].shape[0]
    if n == 0:
        return np.zeros(0, np.int64), 0, "dense"
    lo = [int(c.min()) for c in cols]
    radix = [int(c.max()) - l + 1 for c, l in zip(cols, lo)]
    size = math.prod(radix)
    if size >= 1 << 63:
        group_ids = _rows_group_ids(cols)
        return group_ids, int(group_ids.max()) + 1, "rows"
    code = np.zeros(n, np.int64)
    for c, l, r in zip(cols, lo, radix):
        code *= r
        code += c
        code -= l
    if size <= max(_DENSE_PER_ROW * n, _DENSE_MIN):
        present = np.bincount(code, minlength=size) > 0
        remap = np.cumsum(present) - 1
        return remap[code], int(remap[-1]) + 1, "dense"
    values, group_ids = np.unique(code, return_inverse=True)
    return group_ids.reshape(-1), int(values.shape[0]), "code"


def select_coreset(local: Sequence[ClientClustering], labels: np.ndarray, *,
                   regression_bins: int = 16) -> Tuple[np.ndarray, np.ndarray,
                                                       int]:
    """Steps 4-5 at the label owner. Returns (indices, weights, n_groups).

    Regression labels (float) are quantile-binned so "split S_ct^j by
    label" stays meaningful."""
    with span("coreset.groups", rows=int(labels.shape[0])) as groups_sp:
        ed = np.stack([np.sqrt(np.maximum(c.sq_dist, 0.0)) for c in local],
                      axis=1)                                  # (N, M)
        w = np.stack([c.weight for c in local], axis=1)        # (N, M)

        if np.issubdtype(labels.dtype, np.floating):
            qs = np.quantile(labels,
                             np.linspace(0, 1, regression_bins + 1)[1:-1])
            lab = np.searchsorted(qs, labels).astype(np.int64)
        else:
            lab = labels.astype(np.int64)

        group_ids, n_groups, tier = _group_ids([c.assign for c in local]
                                               + [lab])
        groups_sp.set(n_groups=n_groups, tier=tier)

    with span("coreset.pick") as pick_sp:
        agg_ed = ed.sum(axis=1)
        # argmin aggregated distance per group, ties to the lowest row
        order, packed = _sorted_rows(group_ids, _bits(n_groups), agg_ed)
        sorted_groups = group_ids[order]
        first = np.ones(len(order), bool)
        first[1:] = sorted_groups[1:] != sorted_groups[:-1]
        chosen = np.sort(order[first])
        weights = w[chosen].sum(axis=1)
        pick_sp.set(n_coreset=int(chosen.shape[0]), packed=packed)
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


def local_cluster_weights(features: np.ndarray, k: int, *, seed: int = 0,
                          iters: int = 25, impl: Optional[str] = None,
                          algo: str = "lloyd",
                          device=None) -> ClientClustering:
    """Steps 1-2 on one client's feature slice, with its own
    ``k = min(k, N)`` and key ``PRNGKey(seed)`` (``core/kmeans.
    fit_client`` picks Lloyd or mini-batch as the reference does)."""
    dev = resolve_device(device)
    k_eff = int(min(k, features.shape[0]))
    with span("coreset.kmeans"):
        pts = torch.as_tensor(np.asarray(features, np.float32), device=dev)
        cents, assign, sqd = fit_client(rng.PRNGKey(seed), pts, k_eff,
                                        iters=iters, impl=impl, algo=algo)
        assign = assign.cpu().numpy()
        sqd = sqd.cpu().numpy()
    with span("coreset.rank", rows=int(assign.shape[0])) as rank_sp:
        weight, packed = _rank_weights(assign, sqd, k_eff)
        rank_sp.set(packed=int(packed))
    return ClientClustering(assign, sqd, weight, cents)


def clients_batchable(features: Sequence[np.ndarray], *,
                      algo: str = "lloyd",
                      clusters: Optional[int] = None) -> bool:
    """True when steps 1-2 run as one batched fit, as the reference:
    Lloyd only; same-shape clients always, ragged clients unless some
    client has fewer samples than ``clusters`` (it would need its own
    smaller k)."""
    feats = list(features)
    if algo != "lloyd" or len(feats) <= 1:
        return False
    if len({f.shape for f in feats}) == 1:
        return True
    min_n = min(f.shape[0] for f in feats)
    return min_n >= 1 and (clusters is None or min_n >= clusters)


def _fit_clients(features: Sequence[np.ndarray], k: int, seeds: Sequence[int],
                 *, iters: int, impl: str, device: torch.device,
                 axis: Optional[MeshAxis] = None) -> List[ClientClustering]:
    """Steps 1-2 for a group of clients in ONE batched fit: the slices
    zero-pad to (M, N_max, d_max) (zero columns are exact, zero rows are
    masked through ``n_valid``), k is shared (min over the group), and
    each client's outputs slice back to its true (N_m, d_m).  With
    ``axis`` this rank fits its block of the clients (module docstring)
    and the blocks are all-gathered."""
    m = len(features)
    ns = [int(f.shape[0]) for f in features]
    ds = [int(f.shape[1]) for f in features]
    k_eff = int(min(k, min(ns)))
    mine = my_rows(m, axis)
    with span("coreset.kmeans"):
        keys = np.stack([rng.PRNGKey(seeds[i]) for i in mine])
        stacked = stack_padded([torch.as_tensor(np.asarray(features[i],
                                                           np.float32),
                                                device=device)
                                for i in mine], max(ns), max(ds))
        cents, assign, sqd = kmeans_fit(keys, stacked, k_eff, iters=iters,
                                        impl=impl,
                                        n_valid=[ns[i] for i in mine],
                                        clients=m)
        if axis is not None:
            # one all-gather of each client's (centroids, assign bits, sqd)
            ml = len(mine)
            block = torch.cat([cents.reshape(ml, -1),
                               assign.view(torch.float32), sqd], 1)
            every = all_gather_rows(block, axis)[:m]
            cents = every[:, :k_eff * max(ds)].reshape(m, k_eff, max(ds))
            assign = every[:, k_eff * max(ds):-max(ns)].contiguous().view(
                torch.int32)
            sqd = every[:, -max(ns):]
        assign = assign.cpu().numpy()
        sqd = sqd.cpu().numpy()
    with span("coreset.rank", rows=sum(ns)) as rank_sp:
        ranked = [_rank_weights(assign[i, :ns[i]], sqd[i, :ns[i]], k_eff)
                  for i in range(m)]
        weights = [w for w, _ in ranked]
        rank_sp.set(packed=sum(p for _, p in ranked))
    return [ClientClustering(assign[i, :ns[i]], sqd[i, :ns[i]], weights[i],
                             cents[i, :, :ds[i]])
            for i in range(m)]


def cluster_coreset(partition: VerticalPartition, clusters_per_client: int, *,
                    seed: int = 0, kmeans_iters: int = 25,
                    kmeans_impl: Optional[str] = None, use_he: bool = False,
                    kmeans_algo: str = "lloyd",
                    device=None, mesh=None,
                    shard_axis: Optional[str] = None) -> CoresetResult:
    """Full Cluster-Coreset over a vertical partition.

    All clients fit in one batched device call when
    ``clients_batchable`` allows it (Lloyd only); its wall time / M
    stands for ONE client's concurrent compute in ``per_client_seconds``
    (the max-over-clients makespan model).  ``mesh`` shards that batch
    over ``shard_axis`` (``data`` by default; a 2-D train mesh
    replicates over ``model``), with the same selection (module
    docstring); an axis the mesh lacks raises.
    Otherwise each client fits alone (``local_cluster_weights``), with
    its own k = min(k, N_m), key ``seed + 17·m`` and measured seconds;
    ``kmeans_algo="minibatch"`` always takes that path, unsharded."""
    dev = resolve_device(device)
    impl = resolve_impl(kmeans_impl, dev)
    mesh, axis_name, n_shards = resolve_batch_mesh(mesh, shard_axis)
    feats = list(partition.client_features)
    m = len(feats)
    batched = clients_batchable(feats, algo=kmeans_algo,
                                clusters=clusters_per_client)
    if not batched:
        n_shards = 1
    with span("coreset.fit", clients=m, batched=batched,
              k=clusters_per_client, algo=kmeans_algo, shards=n_shards):
        if batched:
            t0 = time.perf_counter()
            local = _fit_clients(
                feats, clusters_per_client, [seed + 17 * i for i in range(m)],
                iters=kmeans_iters, impl=impl, device=dev,
                axis=None if mesh is None else MeshAxis(mesh, axis_name))
            per_client = [(time.perf_counter() - t0) / m] * m
        else:
            local, per_client = [], []
            for i, f in enumerate(feats):
                t0 = time.perf_counter()
                local.append(local_cluster_weights(
                    f, clusters_per_client, seed=seed + 17 * i,
                    iters=kmeans_iters, impl=impl, algo=kmeans_algo,
                    device=dev))
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
                         select_seconds=select_secs, batched=batched,
                         shards=n_shards)
