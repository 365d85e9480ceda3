"""The port's k-means against the reference on identical inputs: the
Lloyd-step and assign plain versions against the JAX ref and Pallas
kernels on the same centroids, k-means++ seeding, the ragged batched
fit with its n_valid correction, and the empty-cluster reseed.

Tolerances: assignments equal (and, should one differ, the failure
shows its best/second-best d² margin: a flip is legitimate only below
1e-4·(1+d²)); counts exact; sums and centroids rtol=1e-5, atol=1e-5.
Squared distances take atol=1e-5 plus rtol=1e-5 of ‖p‖² + ‖c‖²: the f32
formula ‖p‖² − 2p·c + ‖c‖² cancels terms of that size, so two summation
orders differ by ulps of them, not of the (possibly small) result."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import coreset as jax_coreset
from repro.kernels.kmeans_assign import ops as jax_assign_ops
from repro.kernels.kmeans_assign import ref as jax_assign_ref
from repro.kernels.kmeans_update import ops as jax_update_ops
from repro.kernels.kmeans_update import ref as jax_update_ref
from repro_torch import interop
from repro_torch.core import coreset
from repro_torch.kernels.kmeans_assign import ref as assign_ref
from repro_torch.kernels.kmeans_update import ref as update_ref

# the packages' ``core`` re-exports the function ``kmeans`` over the module
jax_kmeans = importlib.import_module("repro.core.kmeans")
kmeans = importlib.import_module("repro_torch.core.kmeans")
torch.set_num_threads(1)
RTOL = ATOL = 1e-5


def _clients(seed, ns=(300, 300, 300), ds=(4, 5, 3), k=6):
    g = np.random.default_rng(seed)
    pts = [(g.normal(0, 1, (n, d)) + 4 * g.normal(0, 1, (k, d))[
        g.integers(0, k, n)]).astype(np.float32) for n, d in zip(ns, ds)]
    cents = [p[g.choice(len(p), k, replace=False)]
             + np.float32(0.1) * g.normal(0, 1, (k, p.shape[1])).astype(
                 np.float32) for p in pts]
    return pts, cents


def assert_sqd_close(got, want, points, cents, assign):
    scale = ((points.astype(np.float64) ** 2).sum(1)
             + (cents.astype(np.float64) ** 2).sum(1)[np.asarray(assign)])
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    bad = err > ATOL + RTOL * scale
    assert not bad.any(), (f"sqd differs at rows {np.nonzero(bad)[0][:5]}:"
                           f" {err[bad][:5]} vs bound "
                           f"{(ATOL + RTOL * scale)[bad][:5]}")


def assert_same_assign(got, want, points, cents):
    diff = np.nonzero(np.asarray(got) != np.asarray(want))[0]
    if diff.size:
        d = ((points[diff, None, :].astype(np.float64)
              - cents[None].astype(np.float64)) ** 2).sum(-1)
        two = np.sort(d, axis=1)[:, :2]
        raise AssertionError(
            f"{diff.size} assignments differ; rows {diff[:5]} with "
            f"best/second d² {two[:5].tolist()} (near-tie margin bound "
            f"{(1e-4 * (1 + two[:5, 0])).tolist()})")


@pytest.mark.parametrize("jax_impl", ["ref", "pallas"])
@pytest.mark.parametrize("seed", [0, 1])
def test_update_and_assign_match_jax(jax_impl, seed):
    pts, cents = _clients(seed)
    upd = jax_update_ops if jax_impl == "pallas" else jax_update_ref
    asg = jax_assign_ops if jax_impl == "pallas" else jax_assign_ref
    for p, c in zip(pts, cents):
        cl = interop.clustering_from_jax(np.zeros(len(p)), np.zeros(len(p)),
                                         np.zeros(len(p)), c, device="cpu")
        tp = torch.from_numpy(p)[None]
        a, s, sums, counts = update_ref.kmeans_update(tp, cl.centroids[None])
        ja, js, jsums, jcounts = (np.asarray(x) for x in
                                  upd.kmeans_update(p, c))
        assert_same_assign(a[0].numpy(), ja, p, c)
        assert np.array_equal(counts[0].numpy(), jcounts)
        np.testing.assert_allclose(sums[0].numpy(), jsums, rtol=RTOL,
                                   atol=ATOL)
        assert_sqd_close(s[0].numpy(), js, p, c, ja)
        a2, s2 = assign_ref.kmeans_assign(tp, cl.centroids[None])
        ja2, js2 = (np.asarray(x) for x in asg.kmeans_assign(p, c))
        assert_same_assign(a2[0].numpy(), ja2, p, c)
        assert_sqd_close(s2[0].numpy(), js2, p, c, ja2)


def test_batched_update_equals_per_client():
    """One padded (M, N_max, d_max) launch == M single-client launches on
    the real rows (zero columns are exact; zero rows only add counts)."""
    pts, cents = _clients(2, ns=(250, 300, 180))
    from repro_torch.kernels.padding import stack_padded
    stack = stack_padded([torch.from_numpy(p) for p in pts], 300, 5)
    cstack = stack_padded([torch.from_numpy(c) for c in cents], 6, 5)
    a, s, sums, counts = update_ref.kmeans_update(stack, cstack)
    for i, (p, c) in enumerate(zip(pts, cents)):
        a1, s1, sums1, counts1 = update_ref.kmeans_update(
            torch.from_numpy(p)[None], torch.from_numpy(c)[None])
        n, d = p.shape
        assert torch.equal(a[i, :n], a1[0])
        pad_c = int(a[i, -1]) if n < 300 else 0
        fixed = counts[i].clone()
        fixed[pad_c] -= 300 - n
        assert torch.equal(fixed, counts1[0])
        torch.testing.assert_close(sums[i, :, :d], sums1[0], rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("seed", [0, 5])
def test_kmeans_pp_init_matches_jax(seed):
    pts, _ = _clients(seed, ns=(200, 260, 140), ds=(4, 4, 4))
    from repro_torch.kernels.padding import stack_padded
    stack = stack_padded([torch.from_numpy(p) for p in pts], 260, 4)
    ns = [len(p) for p in pts]
    keys = np.stack([np.asarray(jax.random.PRNGKey(seed + 17 * m))
                     for m in range(3)])
    got = kmeans.kmeans_pp_init(
        np.stack([interop.key_from_jax(k) for k in keys]), stack, 7, ns)
    for m in range(3):
        want = jax_kmeans.kmeans_pp_init(
            jnp.asarray(keys[m]), jnp.asarray(stack[m].numpy()), 7,
            n_valid=jnp.int32(ns[m]))
        assert np.array_equal(got[m].numpy(), np.asarray(want)), m


@pytest.mark.parametrize("seed", [0, 3])
def test_ragged_batched_fit_matches_jax(seed):
    """The coreset's batched fit, ragged in N and d (n_valid correction),
    against the reference's vmapped ragged fit with the Pallas kernels."""
    pts, _ = _clients(seed, ns=(240, 300, 170), ds=(4, 5, 3))
    want = jax_coreset._batched_local_clusterings(
        pts, 6, seed=seed, iters=25, impl="pallas")[0]
    got = coreset._fit_clients(pts, 6, [seed + 17 * m for m in range(3)],
                               iters=25, impl="ref",
                               device=torch.device("cpu"))
    for g, w, p in zip(got, want, pts):
        assert_same_assign(g.assign, w.assign, p, w.centroids)
        np.testing.assert_allclose(g.centroids.numpy(), w.centroids,
                                   rtol=RTOL, atol=ATOL)
        assert_sqd_close(g.sq_dist, w.sq_dist, p, w.centroids, w.assign)
        assert np.array_equal(g.weight, w.weight)


def test_empty_cluster_reseed_matches_jax():
    """K far exceeds the distinct points: surplus centroids re-seed at
    the farthest point exactly as the reference does."""
    base = np.array([[0.0, 0.0], [10.0, 10.0], [-10.0, 5.0]], np.float32)
    x = np.repeat(base, 5, axis=0)
    wc, wa, ws = jax_kmeans.kmeans(x, 9, seed=0, iters=10, impl="pallas")
    gc, ga, gs = kmeans.kmeans(x, 9, seed=0, iters=10, device="cpu")
    assert np.array_equal(gc, wc)
    assert np.array_equal(ga, wa)
    assert np.array_equal(gs, ws)
    assert np.isfinite(gc).all() and gs.max() < 1e-3
