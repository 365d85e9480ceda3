"""K-Means (Lloyd) on the device, batched over clients: the port of
``repro.core.kmeans``.

The reference fits each client with a jitted ``lax.scan`` and fits a
group of clients with ``vmap``.  Here a group of M clients is one
zero-padded (M, N, d) stack, and every Lloyd iteration is ONE launch of
the fused update kernel over all M clients (``kernels/kmeans_update``),
then one launch of the assign kernel at the end.  The iterations are a
host loop of launches with no host synchronisation inside.  The
beyond-paper mini-batch fit (``kmeans_minibatch_fit``, one client at a
time as in the reference) runs one launch of the gather-fused update
kernel per Sculley step over the step's sampled rows.

Pad-and-mask contract (the reference's ``n_valid``): rows of client m at
and past ``n_valid[m]`` must be all-zero padding.  Zero rows add exact
+0.0 to every cluster sum, so only the count of the cluster they land
in needs correcting (read from the same update pass, so tie-breaks
match), and the empty-cluster reseed masks them out of the
farthest-point argmax.  Zero columns add exact +0.0 to every distance.

k-means++ seeding draws its random numbers on the host through
``repro_torch.rng`` (threefry, the reference's key stream: one
``randint`` for the first centroid, one ``choice(p=D²)`` per further
centroid); only the data-dependent ``cumsum``/``searchsorted`` of each
draw runs on the device.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import rng
from repro_torch.config import resolve_device, resolve_impl
from repro_torch.kernels.kmeans_assign.ops import kmeans_assign
from repro_torch.kernels.kmeans_update.ops import kmeans_update


def _pp_draws(keys: np.ndarray, k: int, n_valid: Sequence[int]
              ) -> Tuple[np.ndarray, np.ndarray]:
    """The host half of k-means++ for M clients: each client's first
    centroid index and the factors ``1 - u`` of its k-1 D² draws (the
    reference's ``choice`` computes ``cumsum[-1] * (1 - u)``)."""
    first = np.empty(len(keys), np.int64)
    one_minus_u = np.empty((len(keys), max(k - 1, 0)), np.float32)
    for m, key in enumerate(keys):
        key, sub = rng.split(key)
        first[m] = int(rng.randint(sub, (), 0, int(n_valid[m])))
        for i in range(k - 1):
            key, sub = rng.split(key)
            one_minus_u[m, i] = np.float32(1) - rng.uniform(sub)
    return first, one_minus_u


def kmeans_pp_init(keys: np.ndarray, points: torch.Tensor, k: int,
                   n_valid: Sequence[int]) -> torch.Tensor:
    """k-means++ seeding (D² sampling) for M clients at once.

    keys (M, 2) u32, points (M, N, d) f32, ``n_valid`` the clients' true
    row counts -> centroids (M, k, d).  Padded rows get zero D²
    mass, so they are never sampled and leave every cumsum boundary
    (and so every draw) where the unpadded run has it.

    A client's arithmetic does not depend on the other clients of its
    batch, so a sharded fit, whose ranks hold fewer clients, gives the
    same bits: each client's D² total is its own reduction (a batched
    row sum on the card splits its rows by the batch's size), and the
    cumsum runs over the batch with one zero row more (a tensor of one
    row takes another scan on the card, summed in another order)."""
    m, n, d = points.shape
    dev = points.device
    first, one_minus_u = _pp_draws(keys, k, n_valid)
    clients = torch.arange(m, device=dev)
    valid, _ = pad_masks(n, n_valid, dev)
    cents = torch.zeros((m, k, d), dtype=torch.float32, device=dev)
    c = points[clients, torch.from_numpy(first).to(dev)]          # (M, d)
    cents[:, 0] = c
    dists = torch.where(valid, ((points - c[:, None]) ** 2).sum(-1), 0.0)
    factors = torch.from_numpy(one_minus_u).to(dev)
    zero_row = torch.zeros((1, n), dtype=torch.float32, device=dev)
    for i in range(1, k):
        total = torch.stack([row.sum() for row in dists])[:, None]
        probs = dists / total.clamp_min(1e-30)
        cum = torch.cumsum(torch.cat([probs, zero_row]), dim=1)[:m]
        r = cum[:, -1:] * factors[:, i - 1:i]
        idx = torch.searchsorted(cum, r).clamp_max(n - 1)[:, 0]
        c = points[clients, idx]
        cents[:, i] = c
        dists = torch.minimum(dists, ((points - c[:, None]) ** 2).sum(-1))
    return cents


def lloyd_step(points: torch.Tensor, cents: torch.Tensor,
               valid: torch.Tensor, n_pad: torch.Tensor, impl: str,
               clients: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One Lloyd iteration for M clients: one launch of the fused update
    kernel, then the pad-and-mask count correction and the empty-cluster
    reseed.  ``valid`` (M, N) marks real rows, ``n_pad`` (M, 1) counts
    the padding rows; ``clients`` is the batch the kernel sums as
    (``kmeans_update``).  Returns (new centroids, assignment to
    ``cents``)."""
    m, n, _ = points.shape
    k = cents.shape[1]
    assign, sqd, sums, counts = kmeans_update(points, cents, impl=impl,
                                              clients=clients)
    # the cluster the zero padding rows joined, read from the SAME update
    # pass (row n-1 is padding whenever any padding exists; with none the
    # correction multiplies by zero)
    pad_c = assign[:, n - 1].to(torch.int64)
    cluster = torch.arange(k, device=points.device)
    counts = counts - n_pad * (cluster[None, :] == pad_c[:, None])
    sqd = torch.where(valid, sqd, -1.0)
    new = sums / counts.clamp_min(1.0)[..., None]
    # empty clusters: re-seed at the client's farthest point
    far = points[torch.arange(m, device=points.device),
                 torch.argmax(sqd, dim=1)]
    return torch.where((counts > 0)[..., None], new, far[:, None]), assign


def pad_masks(n: int, n_valid: Sequence[int], device
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(valid (M, N) bool, n_pad (M, 1) f32) for clients of true row
    counts ``n_valid`` zero-padded to N rows."""
    nv = torch.as_tensor(list(n_valid), dtype=torch.int64, device=device)
    valid = torch.arange(n, device=device)[None, :] < nv[:, None]
    return valid, (n - nv).to(torch.float32)[:, None]


def kmeans_fit(keys: np.ndarray, points: torch.Tensor, k: int, *,
               iters: int = 25, impl: Optional[str] = None,
               n_valid: Optional[Sequence[int]] = None,
               clients: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fit M clients at once.  keys (M, 2) u32 (one threefry key per
    client), points (M, N, d) on the device, ``n_valid`` the clients'
    true row counts (default N).  Returns (centroids (M, k, d), assign
    (M, N) int32, sq-distances (M, N) f32); the caller slices each
    client back to its true (N_m, d_m).  A rank of a sharded fit passes
    the whole fit's client count as ``clients``, so every client's sums
    run in the order of the unsharded fit (``kmeans_update``)."""
    points = points.float().contiguous()
    m, n, _ = points.shape
    impl = resolve_impl(impl, points.device)
    n_valid = [n] * m if n_valid is None else [int(v) for v in n_valid]
    valid, n_pad = pad_masks(n, n_valid, points.device)
    cents = kmeans_pp_init(np.asarray(keys, np.uint32), points, k, n_valid)
    for _ in range(iters):
        cents, _ = lloyd_step(points, cents, valid, n_pad, impl, clients)
    assign, sqd = kmeans_assign(points, cents, impl=impl)
    return cents, assign, sqd


# rows a Sculley step samples (the reference's default); a client of at
# most this many rows fits with Lloyd
MINIBATCH_BATCH = 1024


def kmeans_minibatch_fit(key: np.ndarray, points: torch.Tensor, k: int, *,
                         iters: int = 25, batch: int = MINIBATCH_BATCH,
                         impl: Optional[str] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Mini-batch K-Means (Sculley 2010) for one client: the port of
    ``repro.core.kmeans.kmeans_minibatch_fit``.  key (2,) u32, points
    (N, d) on the device -> (centroids (k, d), assign (N,) int32,
    sq-distances (N,) f32).

    The reference's key stream, reuse included: ``key, sub = split(key)``
    draws the ``min(N, 4·batch)``-row subsample that k-means++ seeds on,
    and the SAME ``key`` then seeds k-means++ and is split into one key
    a step.  Each step draws ``batch`` row indices with
    ``randint`` (all steps' indices are drawn on the host up front and
    uploaded once), runs one gather-fused update over them (K4 on CUDA)
    and applies the
    Sculley update ``cents + lr·(target − cents)·(counts > 0)`` with
    ``lr = batch_counts / max(counts + batch_counts, 1)``, in the
    reference's order.  The final assignment over all N rows is one
    assign launch (K5)."""
    points = points.float().contiguous()
    n, d = points.shape
    dev = points.device
    impl = resolve_impl(impl, dev)
    key, sub = rng.split(np.asarray(key, np.uint32))
    seed_idx = rng.choice_without_replacement(sub, n, min(n, 4 * batch))
    sample = points[torch.from_numpy(seed_idx).to(dev)][None]
    cents = kmeans_pp_init(key[None], sample, k, [sample.shape[1]])[0]
    steps = np.array([rng.randint(step_key, (batch,), 0, n)
                      for step_key in rng.split(key, iters)], np.int32)
    steps = torch.from_numpy(steps.reshape(iters, batch)).to(dev)
    counts = torch.zeros(k, dtype=torch.float32, device=dev)
    for i in range(iters):
        _, _, sums, batch_counts = kmeans_update(
            points[None], cents[None], impl=impl, idx=steps[i:i + 1])
        sums, batch_counts = sums[0], batch_counts[0]
        new_counts = counts + batch_counts
        # per-center learning rate 1/count (Sculley eq. 1)
        target = sums / batch_counts.clamp_min(1.0)[:, None]
        lr = batch_counts / new_counts.clamp_min(1.0)
        cents = cents + lr[:, None] * (target - cents) * (
            batch_counts > 0)[:, None].float()
        counts = new_counts
    assign, sqd = kmeans_assign(points[None], cents[None], impl=impl)
    return cents, assign[0], sqd[0]


def fit_client(key: np.ndarray, points: torch.Tensor, k: int, *,
               iters: int = 25, impl: Optional[str] = None,
               algo: str = "lloyd", batch: int = MINIBATCH_BATCH
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One client's fit, as the reference's ``kmeans`` picks it:
    ``algo="minibatch"`` (beyond the paper, Sculley 2010) runs
    ``kmeans_minibatch_fit`` with ``batch`` rows a step when the client
    has more than ``batch`` rows, and everything else the Lloyd
    ``kmeans_fit``.  points (N, d) on the device -> (centroids (k, d),
    assign (N,), sq-distances (N,))."""
    if algo not in ("lloyd", "minibatch"):
        raise ValueError(f"algo must be 'lloyd' or 'minibatch', got {algo!r}")
    if algo == "minibatch" and points.shape[0] > batch:
        return kmeans_minibatch_fit(key, points, k, iters=iters, batch=batch,
                                    impl=impl)
    c, a, s = kmeans_fit(np.asarray(key, np.uint32)[None], points[None], k,
                         iters=iters, impl=impl)
    return c[0], a[0], s[0]


def kmeans(points: np.ndarray, k: int, *, seed: int = 0, iters: int = 25,
           impl: Optional[str] = None, algo: str = "lloyd",
           batch: int = MINIBATCH_BATCH, device=None
           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """numpy-facing single-client fit (``fit_client`` from
    ``PRNGKey(seed)``, ``batch`` rows a minibatch step).  Returns
    (centroids, assign, sq_dists) as numpy arrays."""
    dev = resolve_device(device)
    pts = torch.as_tensor(np.asarray(points, np.float32), device=dev)
    c, a, s = fit_client(rng.PRNGKey(seed), pts, int(k), iters=iters,
                         impl=impl, algo=algo, batch=int(batch))
    return c.cpu().numpy(), a.cpu().numpy(), s.cpu().numpy()
