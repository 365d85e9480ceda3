"""The beyond-paper mini-batch Cluster-Coreset against the reference:
the K4 plain version (gather, then the K3 plain version) against the
reference's ``kmeans_update(points, cents, idx=)`` with its jnp ref and
with interpret-mode Pallas, ``kmeans_minibatch_fit`` and ``kmeans(algo=)``
against the reference's, ``cluster_coreset(kmeans_algo="minibatch")``
end to end, and the V-coreset baseline byte for byte.

Tolerances: assignments and counts exact; sums rtol=atol=1e-5 and
squared distances atol=1e-5 plus rtol=1e-5 of ‖p‖² + ‖c‖² (ROADMAP §3
N3, as tests/test_torch_kmeans.py).  Mini-batch centroids within
rtol=atol=1e-5 of the reference's: the Sculley update ``c + lr·(t −
c)·mask`` is a multiply and an add that XLA's CPU code may contract
into one FMA, which the port's eager ops do not, so the two may differ
in the last bits of each step."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import coreset as jax_coreset
from repro.data.synthetic import DATASETS, make_dataset
from repro.data.vertical import partition_features
from repro.kernels.kmeans_update import ops as jax_update_ops
from repro.kernels.kmeans_update import ref as jax_update_ref
from repro_torch import rng
from repro_torch.core import coreset
from repro_torch.core import vcoreset
from repro_torch.data.vertical import VerticalPartition
from repro_torch.kernels.kmeans_update import ref as update_ref
from repro_torch.kernels.kmeans_update.ops import kmeans_update
from test_torch_kmeans import assert_same_assign, assert_sqd_close

# the packages' ``core`` re-exports functions over these module names
jax_kmeans = importlib.import_module("repro.core.kmeans")
jax_vcoreset = importlib.import_module("repro.core.vcoreset")
kmeans = importlib.import_module("repro_torch.core.kmeans")
torch.set_num_threads(1)
RTOL = ATOL = 1e-5


def _blobs(n, d, k, seed):
    g = np.random.default_rng(seed)
    return (g.normal(0, 1, (n, d)) + 4 * g.normal(0, 1, (k, d))[
        g.integers(0, k, n)]).astype(np.float32)


def _port(part):
    return VerticalPartition(part.client_features, part.labels,
                             part.feature_slices)


@pytest.mark.parametrize("jax_impl", ["ref", "pallas"])
@pytest.mark.parametrize("b", [17, 300, 1024])
def test_gather_update_matches_jax(jax_impl, b):
    """K4's plain version against the reference's gather-fused update,
    duplicated indices included (the Sculley sampler draws them)."""
    g = np.random.default_rng(b)
    p = _blobs(400, 9, 6, seed=b)
    c = p[g.choice(400, 6, replace=False)] + np.float32(0.1)
    idx = g.integers(0, 400, b).astype(np.int32)
    idx[:3] = idx[0]
    if jax_impl == "pallas":
        want = jax_update_ops.kmeans_update(jnp.asarray(p), jnp.asarray(c),
                                            idx=jnp.asarray(idx))
    else:
        want = jax_update_ref.kmeans_update(jnp.asarray(p)[idx],
                                            jnp.asarray(c))
    ja, js, jsums, jcounts = (np.asarray(x) for x in want)
    a, s, sums, counts = kmeans_update(
        torch.from_numpy(p)[None], torch.from_numpy(c)[None],
        idx=torch.from_numpy(idx)[None])
    assert a.shape == (1, b) and s.shape == (1, b)
    assert_same_assign(a[0].numpy(), ja, p[idx], c)
    assert np.array_equal(counts[0].numpy(), jcounts)
    np.testing.assert_allclose(sums[0].numpy(), jsums, rtol=RTOL, atol=ATOL)
    assert_sqd_close(s[0].numpy(), js, p[idx], c, ja)


def test_gather_update_is_dense_update_on_gathered_rows():
    """Batched over M clients, each with its own indices: equal to the
    dense plain version on ``points[i, idx[i]]``; an index outside
    [0, N) raises on the CPU."""
    g = np.random.default_rng(4)
    pts = torch.from_numpy(np.stack([_blobs(300, 5, 4, seed=i)
                                     for i in range(3)]))
    cents = pts[:, :4].clone()
    idx = torch.from_numpy(g.integers(0, 300, (3, 50)).astype(np.int32))
    got = update_ref.kmeans_update_gather(pts, cents, idx)
    rows = torch.stack([pts[i, idx[i].long()] for i in range(3)])
    for x, y in zip(got, update_ref.kmeans_update(rows, cents)):
        assert torch.equal(x, y)
    idx[1, 7] = 300
    with pytest.raises((IndexError, RuntimeError)):
        update_ref.kmeans_update_gather(pts, cents, idx)


@pytest.mark.parametrize("seed", [0, 3])
def test_minibatch_fit_matches_jax(seed):
    """The whole fit from one key: the subsample, the k-means++ seeding
    on it, the per-step draws and Sculley updates, the final assign."""
    x = _blobs(3000, 6, 8, seed=seed)
    key = jax.random.PRNGKey(seed)
    wc, wa, ws = (np.asarray(v) for v in jax_kmeans.kmeans_minibatch_fit(
        key, jnp.asarray(x), 8, iters=10, batch=kmeans.MINIBATCH_BATCH,
        impl="ref"))
    gc, ga, gs = kmeans.kmeans_minibatch_fit(
        rng.PRNGKey(seed), torch.from_numpy(x), 8, iters=10)
    np.testing.assert_allclose(gc.numpy(), wc, rtol=RTOL, atol=ATOL)
    assert_same_assign(ga.numpy(), wa, x, wc)
    assert_sqd_close(gs.numpy(), ws, x, wc, wa)


@pytest.mark.parametrize("algo,n", [("minibatch", 3000), ("minibatch", 1024),
                                    ("lloyd", 3000)])
def test_kmeans_algo_matches_jax(algo, n):
    """``kmeans(algo=)`` picks as the reference: mini-batch only when
    N > the 1,024-row batch, Lloyd otherwise."""
    x = _blobs(n, 4, 5, seed=n)
    wc, wa, _ = jax_kmeans.kmeans(x, 5, seed=2, iters=8, impl="ref",
                                  algo=algo, batch=kmeans.MINIBATCH_BATCH)
    gc, ga, _ = kmeans.kmeans(x, 5, seed=2, iters=8, algo=algo,
                              device="cpu")
    np.testing.assert_allclose(gc, wc, rtol=RTOL, atol=ATOL)
    assert_same_assign(ga, wa, x, wc)
    with pytest.raises(ValueError, match="algo"):
        kmeans.kmeans(x, 5, algo="elkan", device="cpu")


@pytest.fixture(scope="module")
def yp_part():
    """A YP-shaped train partition (90 columns, 3 clients of 30)."""
    x, y = make_dataset(DATASETS["YP"], seed=0, n_override=2600)
    return partition_features(x, y, 3)


@pytest.mark.parametrize("seed", [0, 1])
def test_cluster_coreset_minibatch_matches_jax(yp_part, seed):
    want = jax_coreset.cluster_coreset(yp_part, 12, seed=seed,
                                       kmeans_algo="minibatch")
    got = coreset.cluster_coreset(_port(yp_part), 12, seed=seed,
                                  kmeans_algo="minibatch", device="cpu")
    assert got.batched is want.batched is False
    assert len(got.per_client_seconds) == 3
    assert np.array_equal(got.indices, want.indices)
    assert np.array_equal(got.weights, want.weights)
    assert got.n_groups == want.n_groups
    assert got.comm_bytes == want.comm_bytes
    for g, w in zip(got.local, want.local):
        assert np.array_equal(g.assign, w.assign)
        assert_weights_equal_off_near_ties(g, w)


def assert_weights_equal_off_near_ties(got, want):
    """Local rank weights are equal, except that two rows of a cluster
    whose squared distances lie within 1e-5 + 2e-5·max(d², 1) of each
    other may swap ranks (the two f32 distance orders part by ulps of
    the cancelled terms there, ROADMAP §3 N3)."""
    for i in np.nonzero(got.weight != want.weight)[0]:
        same = np.nonzero((want.assign == want.assign[i])
                          & (want.weight == got.weight[i]))[0]
        gap = np.abs(want.sq_dist[same].astype(np.float64)
                     - want.sq_dist[i])
        lim = ATOL + RTOL * 2 * max(float(want.sq_dist[i]), 1.0)
        assert same.size and gap.min() <= lim, (
            f"row {i}: weight {got.weight[i]} vs {want.weight[i]}, no "
            f"near tie (closest gap {gap.min() if same.size else None})")


@pytest.mark.parametrize("algo", ["lloyd", "minibatch"])
def test_local_cluster_weights_matches_jax(yp_part, algo):
    f = yp_part.client_features[1]
    want = jax_coreset.local_cluster_weights(f, 12, seed=17, algo=algo)
    got = coreset.local_cluster_weights(f, 12, seed=17, algo=algo,
                                        device="cpu")
    assert np.array_equal(got.assign, want.assign)
    assert_weights_equal_off_near_ties(got, want)
    np.testing.assert_allclose(got.centroids.numpy(), want.centroids,
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("algo", ["lloyd", "minibatch"])
def test_clients_batchable_matches_jax(yp_part, algo):
    feats = yp_part.client_features
    for ragged in (feats, [feats[0], feats[1][:5]]):
        assert (coreset.clients_batchable(ragged, algo=algo, clusters=12)
                == jax_coreset.clients_batchable(ragged, algo=algo,
                                                 clusters=12))


@pytest.mark.parametrize("size,seed", [(80, 0), (300, 4)])
def test_vcoreset_byte_identical(yp_part, size, seed):
    for got, want in zip(vcoreset.vcoreset(_port(yp_part), size, seed=seed),
                         jax_vcoreset.vcoreset(yp_part, size, seed=seed)):
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert (vcoreset.leverage_scores(_port(yp_part)).tobytes()
            == jax_vcoreset.leverage_scores(yp_part).tobytes())


def test_yp_slice_pipeline_matches_reference():
    """The whole slice at a small YP shape: ``run_pipeline`` treecss ×
    linreg on 3,000 rows × 90 columns (2,100 train, 3 clients of 30),
    k=12, OPRF on the device backend, against the reference with the
    training slice's tolerances (tests/test_torch_pipeline.py): alignment,
    coreset and training counters exact, epoch losses and the MSE within
    rtol 1e-3."""
    from repro.config import AlignOptions as JaxAlign
    from repro.config import EngineOptions as JaxEngine
    from repro.core.splitnn import SplitNNConfig as JaxConfig
    from repro.core.treecss import run_pipeline as jax_run_pipeline
    from repro_torch.config import AlignOptions, EngineOptions
    from repro_torch.core.splitnn import SplitNNConfig
    from repro_torch.core.treecss import run_pipeline

    n = 3000
    x, y = make_dataset(DATASETS["YP"], seed=0, n_override=n)
    order = np.random.default_rng(1).permutation(n)
    tr = partition_features(x[order[:2100]], y[order[:2100]], 3)
    te = partition_features(x[order[2100:]], y[order[2100:]], 3)
    kw = dict(model="linreg", n_classes=0, lr=0.05, batch_size=64,
              max_epochs=5)
    want = jax_run_pipeline(
        tr, te, JaxConfig(**kw), variant="treecss", clusters_per_client=12,
        kmeans_impl="ref", seed=0, options=JaxEngine(bottom_impl="pallas"),
        align=JaxAlign(protocol="oprf", psi_backend="device", impl="pallas"))
    got = run_pipeline(
        _port(tr), _port(te), SplitNNConfig(**kw), variant="treecss",
        clusters_per_client=12, seed=0, options=EngineOptions(device="cpu"),
        align=AlignOptions(protocol="oprf", psi_backend="device"))
    assert got.mpsi.intersection.shape[0] == 1470
    assert np.array_equal(got.mpsi.intersection, want.mpsi.intersection)
    for f in ("rounds", "total_bytes", "total_messages", "schedule",
              "device_dispatches"):
        assert getattr(got.mpsi, f) == getattr(want.mpsi, f), f
    assert np.array_equal(got.coreset.indices, want.coreset.indices)
    assert np.array_equal(got.coreset.weights, want.coreset.weights)
    for f in ("epochs", "steps", "comm_bytes"):
        assert getattr(got.train, f) == getattr(want.train, f), f
    np.testing.assert_allclose(got.train.losses, want.train.losses,
                               rtol=1e-3)
    np.testing.assert_allclose(got.metric, want.metric, rtol=1e-3)
