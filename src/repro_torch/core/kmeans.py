"""K-Means (Lloyd) on the device, batched over clients: the port of
``repro.core.kmeans``.

The reference fits each client with a jitted ``lax.scan`` and fits a
group of clients with ``vmap``.  Here a group of M clients is one
zero-padded (M, N, d) stack, and every Lloyd iteration is ONE launch of
the fused update kernel over all M clients (``kernels/kmeans_update``),
then one launch of the assign kernel at the end.  The iterations are a
host loop of launches with no host synchronisation inside.

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
        first[m] = rng.randint(sub, 0, int(n_valid[m]))
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
    (and so every draw) where the unpadded run has it."""
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
    for i in range(1, k):
        probs = dists / dists.sum(1, keepdim=True).clamp_min(1e-30)
        cum = torch.cumsum(probs, dim=1)
        r = cum[:, -1:] * factors[:, i - 1:i]
        idx = torch.searchsorted(cum, r).clamp_max(n - 1)[:, 0]
        c = points[clients, idx]
        cents[:, i] = c
        dists = torch.minimum(dists, ((points - c[:, None]) ** 2).sum(-1))
    return cents


def lloyd_step(points: torch.Tensor, cents: torch.Tensor,
               valid: torch.Tensor, n_pad: torch.Tensor, impl: str
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One Lloyd iteration for M clients: one launch of the fused update
    kernel, then the pad-and-mask count correction and the empty-cluster
    reseed.  ``valid`` (M, N) marks real rows, ``n_pad`` (M, 1) counts
    the padding rows.  Returns (new centroids, assignment to ``cents``)."""
    m, n, _ = points.shape
    k = cents.shape[1]
    assign, sqd, sums, counts = kmeans_update(points, cents, impl=impl)
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
               n_valid: Optional[Sequence[int]] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fit M clients at once.  keys (M, 2) u32 (one threefry key per
    client), points (M, N, d) on the device, ``n_valid`` the clients'
    true row counts (default N).  Returns (centroids (M, k, d), assign
    (M, N) int32, sq-distances (M, N) f32); the caller slices each
    client back to its true (N_m, d_m)."""
    points = points.float().contiguous()
    m, n, _ = points.shape
    impl = resolve_impl(impl, points.device)
    n_valid = [n] * m if n_valid is None else [int(v) for v in n_valid]
    valid, n_pad = pad_masks(n, n_valid, points.device)
    cents = kmeans_pp_init(np.asarray(keys, np.uint32), points, k, n_valid)
    for _ in range(iters):
        cents, _ = lloyd_step(points, cents, valid, n_pad, impl)
    assign, sqd = kmeans_assign(points, cents, impl=impl)
    return cents, assign, sqd


def kmeans(points: np.ndarray, k: int, *, seed: int = 0, iters: int = 25,
           impl: Optional[str] = None, device=None
           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """numpy-facing single-client fit.  Returns (centroids, assign,
    sq_dists) as numpy arrays."""
    dev = resolve_device(device)
    pts = torch.as_tensor(np.asarray(points, np.float32), device=dev)[None]
    c, a, s = kmeans_fit(rng.PRNGKey(seed)[None], pts, int(k), iters=iters,
                         impl=impl)
    return c[0].cpu().numpy(), a[0].cpu().numpy(), s[0].cpu().numpy()
