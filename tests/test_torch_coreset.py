"""The port's Cluster-Coreset against the reference: weighting and
selection on the reference's own clusterings carried over through
``interop`` (exact), and ``cluster_coreset`` end to end on identical
inputs (indices, weights, group count and bytes exact)."""
import numpy as np
import pytest
import torch

from repro.core import coreset as jax_coreset
from repro.data.synthetic import DatasetSpec, make_dataset
from repro.data.vertical import partition_features
from repro_torch import interop
from repro_torch.core import coreset
from repro_torch.data.vertical import VerticalPartition

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
