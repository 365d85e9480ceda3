"""The port's Cluster-Coreset against the reference: weighting and
selection on the reference's own clusterings carried over through
``interop`` (exact), and ``cluster_coreset`` end to end on identical
inputs (indices, weights, group count and bytes exact).

The packed sorts of weighting and selection (one integer word a row)
against the row-wise forms they fall back to, bit for bit, on inputs
that reach each tier and each fallback; and against the benchmark's
plain reference (``perfbench/reference/vfl.py``) at 20,000 rows."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import coreset as jax_coreset
from repro.data.synthetic import DatasetSpec, make_dataset
from repro.data.vertical import partition_features
from repro_torch import interop
from repro_torch.core import coreset
from repro_torch.data.vertical import VerticalPartition
from repro_torch.obs.trace import Tracer, use_tracer

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
from perfbench.reference import vfl as plain  # noqa: E402

torch.set_num_threads(1)


def _partition(n=420, d=11, seed=0, clients=3):
    x, y = make_dataset(DatasetSpec("t", n, d, 2), seed=seed)
    return partition_features(x, y, clients)


def _port(part):
    return VerticalPartition(part.client_features, part.labels,
                             part.feature_slices)


@pytest.fixture(scope="module", params=[(0, 6), (1, 9)])
def reference(request):
    seed, k = request.param
    part = _partition(seed=seed)
    res = jax_coreset.cluster_coreset(part, k, seed=seed,
                                      kmeans_impl="pallas")
    return part, k, seed, res


def test_rank_weights_and_selection_on_reference_clusterings(reference):
    part, k, _, res = reference
    local = [interop.clustering_from_jax(c.assign, c.sq_dist, c.weight,
                                         c.centroids, device="cpu")
             for c in res.local]
    for got, want in zip(local, res.local):
        assert np.array_equal(coreset.rank_weights(got.assign, got.sq_dist,
                                                   k), want.weight)
    idx, w, n_groups = coreset.select_coreset(local, part.labels)
    assert np.array_equal(idx, res.indices)
    assert np.array_equal(w, res.weights)
    assert n_groups == res.n_groups


def test_cluster_coreset_end_to_end(reference):
    part, k, seed, res = reference
    got = coreset.cluster_coreset(_port(part), k, seed=seed, device="cpu")
    assert got.batched == res.batched
    assert np.array_equal(got.indices, res.indices)
    assert np.array_equal(got.weights, res.weights)
    assert got.n_groups == res.n_groups
    assert got.comm_bytes == res.comm_bytes
    for g, w in zip(got.local, res.local):
        assert np.array_equal(g.assign, w.assign)


def test_small_client_fits_alone_with_its_own_k():
    """A client with fewer rows than k cannot share the batched k: each
    client then fits alone with k = min(k, N_m), as the reference."""
    part = _partition(n=300, d=6, seed=2, clients=2)
    small = partition_features(
        np.concatenate([part.client_features[0][:5],
                        part.client_features[1][:5]], axis=1)[:5],
        part.labels[:5], 2)
    ragged = type(part)([part.client_features[0], small.client_features[1]],
                        part.labels, part.feature_slices)
    assert not jax_coreset.clients_batchable(ragged.client_features,
                                             clusters=8)
    feats = ragged.client_features
    assert not coreset.clients_batchable(feats, clusters=8)
    for i, f in enumerate(feats):
        (got,) = coreset._fit_clients([f], 8, [17 * i], iters=25,
                                      impl="ref", device=torch.device("cpu"))
        want = jax_coreset.local_cluster_weights(f, 8, seed=17 * i,
                                                 impl="pallas")
        assert np.array_equal(got.assign, want.assign)
        assert np.array_equal(got.weight, want.weight)


def test_he_exchange_cost_matches_reference(reference):
    part, _, _, res = reference
    local = [interop.clustering_from_jax(c.assign, c.sq_dist, c.weight,
                                         c.centroids, device="cpu")
             for c in res.local]
    for use_he in (False, True):
        got, _ = coreset._he_exchange_cost(local, part.n_samples, use_he)
        want, _ = jax_coreset._he_exchange_cost(res.local, part.n_samples,
                                                use_he)
        assert got == want


# ------------------------------------------- packed sorts against row-wise


def _lexsort_weights(assign, sq_dist, k):
    """Step-2 weights from ``lexsort``'s order, as the port computed them
    before the packed sort: the oracle of ``rank_weights``."""
    n = assign.shape[0]
    if n == 0:
        return np.zeros(0, np.float32)
    ed = np.sqrt(np.maximum(sq_dist, 0.0))
    order = np.lexsort((-ed, assign))
    sizes = np.bincount(assign, minlength=k)
    starts = np.concatenate(([0], np.cumsum(sizes)[:-1]))
    sorted_assign = assign[order]
    pos = np.arange(1, n + 1) - starts[sorted_assign]
    weight = np.zeros(n, np.float64)
    weight[order] = pos / sizes[sorted_assign]
    return weight.astype(np.float32)


def _sq_dists(rng, n, kind="spread"):
    """f32 squared distances: ``spread`` continuous with some zeros,
    ``ties`` a few values with -0.0 beside 0.0 and a rounding-negative
    reading, ``nan``/``inf`` one such value."""
    if kind == "ties":
        sq = rng.choice(np.array([0.0, -0.0, 0.25, 1.0, 4.0, -1e-7],
                                 np.float32), n)
    else:
        sq = rng.random(n, dtype=np.float32) * 4
        sq[rng.random(n) < 0.05] = 0.0
    if kind in ("nan", "inf") and n:
        sq[n // 2] = np.nan if kind == "nan" else np.inf
    return sq.astype(np.float32)


#: case: (rows, clusters, distances, clusters used, packed expected)
RANK_CASES = {
    "ties": (600, 4, "ties", None, True),
    "empty_cluster": (500, 6, "spread", [0, 1, 3, 5], True),
    "n0": (0, 3, "spread", None, False),
    "n1": (1, 3, "spread", None, True),
    "n_pow2": (1024, 7, "ties", None, True),
    "n_pow2_plus1": (1025, 7, "spread", None, True),
    "nan": (300, 5, "nan", None, False),
    "inf": (300, 5, "inf", None, False),
    "f64": (300, 5, "f64", None, False),
    # a cluster a row at 2**16 + 1 rows: 17 + 31 + 17 bits pass 64
    "wide": (65537, 65537, "spread", "each", False),
}


def _rank_input(case):
    n, k, dist, used, packed = RANK_CASES[case]
    rng = np.random.default_rng(sorted(RANK_CASES).index(case))
    if used == "each":
        assign = rng.permutation(n).astype(np.int32)
    else:
        assign = rng.choice(np.arange(k) if used is None else
                            np.array(used), n).astype(np.int32)
    sq = _sq_dists(rng, n, "spread" if dist == "f64" else dist)
    if dist == "f64":
        sq = sq.astype(np.float64)
    return assign, sq, k, packed


@pytest.mark.parametrize("case", list(RANK_CASES))
def test_packed_rank_weights_match_lexsort(case):
    assign, sq, k, want_packed = _rank_input(case)
    got, packed = coreset._rank_weights(assign, sq, k)
    assert packed == want_packed
    want = _lexsort_weights(assign, sq, k)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert np.array_equal(coreset.rank_weights(assign, sq, k), got)


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("values", ["signed_zeros", "ties", "extremes"])
def test_packed_order_matches_lexsort(values, descending):
    """The word sort orders f32 values >= 0 as ``lexsort`` does: -0.0
    ties with 0.0, equal values keep row order, subnormals and the
    largest finite f32 sit where their values put them."""
    rng = np.random.default_rng(3)
    n = 4099
    pool = {"signed_zeros": [0.0, -0.0, 1.0],
            "ties": [0.5, 0.25, 2.0, 3.0],
            "extremes": [0.0, 1e-45, 1e-40, 1.1754944e-38, 1.0,
                         3.4028235e38]}[values]
    x = rng.choice(np.array(pool, np.float32), n)
    major = rng.integers(0, 5, n)
    got, packed = coreset._sorted_rows(major, coreset._bits(5), x,
                                       descending=descending)
    assert packed
    assert np.array_equal(got, np.lexsort((-x if descending else x, major)))


def _rowwise_select(local, labels, regression_bins=16):
    """Steps 4-5 by the row-wise forms alone (``_rows_group_ids`` and
    ``lexsort``): the oracle of ``select_coreset``."""
    ed = np.stack([np.sqrt(np.maximum(c.sq_dist, 0.0)) for c in local],
                  axis=1)
    w = np.stack([c.weight for c in local], axis=1)
    if np.issubdtype(labels.dtype, np.floating):
        qs = np.quantile(labels,
                         np.linspace(0, 1, regression_bins + 1)[1:-1])
        lab = np.searchsorted(qs, labels).astype(np.int64)
    else:
        lab = labels.astype(np.int64)
    if not labels.shape[0]:
        return np.zeros(0, np.int64), np.zeros(0, np.float32), 0
    group_ids = coreset._rows_group_ids([c.assign for c in local] + [lab])
    order = np.lexsort((ed.sum(axis=1), group_ids))
    first = np.ones(len(order), bool)
    first[1:] = group_ids[order][1:] != group_ids[order][:-1]
    chosen = np.sort(order[first])
    return (chosen.astype(np.int64), w[chosen].sum(axis=1).astype(np.float32),
            int(group_ids.max()) + 1)


#: case: (rows, clients, clusters, labels, distances, tier, pick packed)
SELECT_CASES = {
    **{f"m{m}": (2000, m, 4, "int", "spread", "dense", True)
       for m in range(1, 7)},
    "float_labels": (5000, 3, 12, "float", "spread", "dense", True),
    "signed_labels": (3000, 3, 5, "signed", "spread", "dense", True),
    "ties": (3000, 3, 3, "int", "ties", "dense", True),
    "empty_cluster": (1500, 3, 8, "int", "empty", "dense", True),
    "n0": (0, 3, 4, "int", "spread", "dense", True),
    "n1": (1, 3, 4, "int", "spread", "dense", True),
    "n_pow2": (1024, 3, 6, "float", "ties", "dense", True),
    "n_pow2_plus1": (1025, 3, 6, "int", "spread", "dense", True),
    # 1,000**3 x 2 codes: past a dense table, inside 63 bits
    "code_tier": (3000, 3, 1000, "int", "spread", "code", True),
    # 2,048**6 x 2 codes pass 63 bits; (2**21)**3 x 1 reach 2**63
    "rows_tier": (3000, 6, 2048, "int", "spread", "rows", True),
    "rows_at_2_63": (3000, 3, 1 << 21, "zero", "spread", "rows", True),
    # 2**16 + 1 one-row groups: 17 + 31 + 17 bits pass 64
    "pick_wide": (65537, 2, 256, "one", "spread", "dense", False),
    "nan": (2000, 3, 4, "int", "nan", "dense", False),
}


def _select_input(case):
    n, m, k, labels, dist, tier, packed = SELECT_CASES[case]
    rng = np.random.default_rng(100 + sorted(SELECT_CASES).index(case))
    local = []
    for i in range(m):
        if labels == "one":              # every row a group of its own
            assign = (np.arange(n) // k if i == 0 else np.arange(n) % k)
        elif dist == "empty":
            assign = rng.choice(np.array([0, 2, 3, 7]), n)
        else:
            assign = rng.integers(0, k, n)
            if tier != "dense":          # the code's radix is k exactly
                assign[:2] = (0, k - 1)
        sq = _sq_dists(rng, n, "nan" if dist == "nan" and i == 1 else
                       "ties" if dist == "ties" else "spread")
        weight = rng.random(n, dtype=np.float32)
        local.append(coreset.ClientClustering(assign.astype(np.int32), sq,
                                              weight, torch.zeros(k, 1)))
    lab = {"int": lambda: rng.integers(0, 2, n),
           "signed": lambda: rng.integers(-3, 4, n),
           "one": lambda: np.zeros(n, np.int64),
           "zero": lambda: np.zeros(n, np.int64),
           "float": lambda: rng.standard_normal(n).astype(np.float32),
           }[labels]()
    return local, lab, tier, packed


@pytest.mark.parametrize("case", list(SELECT_CASES))
def test_packed_selection_matches_rowwise(case):
    local, labels, tier, packed = _select_input(case)
    tracer = Tracer()
    with use_tracer(tracer):
        idx, w, n_groups = coreset.select_coreset(local, labels)
    (groups,) = tracer.by_name("coreset.groups")
    (pick,) = tracer.by_name("coreset.pick")
    assert (groups.attrs["tier"], pick.attrs["packed"]) == (tier, packed)
    want_idx, want_w, want_groups = _rowwise_select(local, labels)
    assert n_groups == want_groups == groups.attrs["n_groups"]
    assert idx.dtype == np.int64 and np.array_equal(idx, want_idx)
    assert w.dtype == np.float32
    assert np.array_equal(w.view(np.uint32), want_w.view(np.uint32))


@pytest.mark.parametrize("labels", ["int", "float"])
def test_selection_matches_the_plain_reference(labels):
    n, m, k = 20000, 3, 12
    rng = np.random.default_rng(7 if labels == "int" else 8)
    assigns = [rng.integers(0, k, n).astype(np.int32) for _ in range(m)]
    sqs = [_sq_dists(rng, n, "ties" if i == 0 else "spread")
           for i in range(m)]
    lab = (rng.integers(0, 2, n) if labels == "int"
           else rng.standard_normal(n).astype(np.float32))
    local = []
    for a, s in zip(assigns, sqs):
        w = coreset.rank_weights(a, s, k)
        assert np.array_equal(w, plain.rank_weights(a, s, k))
        local.append(coreset.ClientClustering(a, s, w, torch.zeros(k, 1)))
    idx, w, _ = coreset.select_coreset(local, lab)
    rows, wsum = plain.select(assigns, sqs, lab, k)
    assert np.array_equal(idx, rows)
    assert np.array_equal(w, wsum)
