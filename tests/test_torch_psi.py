"""The port's alignment path against the reference: the PRF and merge
plain versions bitwise against the JAX kernels (run as the JAX tests run
them, interpret-mode Pallas), engine rounds against numpy set semantics
and the JAX engine, and the MPSI schedulers' stats exactly."""
import numpy as np
import pytest
import torch

from repro.config import AlignOptions as JaxAlign
from repro.core import mpsi as jax_mpsi
from repro.kernels.psi_prf.ops import prf_tags as jax_prf_tags
from repro.kernels.sorted_intersect.ops import \
    sorted_intersect as jax_sorted_intersect
from repro.psi import engine as jax_engine
from repro_torch.config import AlignOptions
from repro_torch.core import mpsi
from repro_torch.kernels.psi_prf import ref as prf_ref
from repro_torch.kernels.sorted_intersect import ref as si_ref
from repro_torch.psi import engine

torch.set_num_threads(1)
CPU = AlignOptions(device="cpu")


def _lanes(x: np.ndarray):
    u = x.astype(np.uint64)
    return ((u >> np.uint64(32)).astype(np.uint32),
            (u & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def _join(hi, lo) -> np.ndarray:
    return ((np.asarray(hi).astype(np.uint64) << np.uint64(32))
            | np.asarray(lo).astype(np.uint64)).astype(np.int64)


@pytest.mark.parametrize("n", [1, 7, 1000, 5000])
def test_prf_tags_match_jax_kernel(n):
    g = np.random.default_rng(n)
    ids = g.integers(0, 2 ** 63 - 1, (2, n), dtype=np.int64)
    seeds = g.integers(0, 2 ** 32, (2, 2), dtype=np.int64)
    got = prf_ref.prf_tags(torch.from_numpy(ids),
                           torch.from_numpy(seeds)).numpy()
    for row in range(2):
        th, tl = jax_prf_tags(*_lanes(ids[row]),
                              seeds[row].astype(np.uint32), impl="pallas")
        assert np.array_equal(got[row], _join(th, tl))
    assert got.min() >= 0 and got.max() < 2 ** 62


def _key_rows(p: int, n_a: int, n_b: int, n_common: int, seed: int):
    """Padded ascending receiver (origin 1) / sender (origin 0) keys."""
    g = np.random.default_rng(seed)
    tags = g.permutation(np.unique(g.integers(0, 2 ** 62, 3 * p,
                                              dtype=np.int64)))
    ta = np.sort(np.concatenate([tags[:n_common], tags[n_common:n_a]]))
    tb = np.sort(np.concatenate([tags[:n_common],
                                 tags[n_a:n_a + n_b - n_common]]))
    a = np.full(p, si_ref.PAD_A64, np.int64)
    b = np.full(p, si_ref.PAD_B64, np.int64)
    a[:n_a] = (ta << 1) | 1
    b[:n_b] = tb << 1
    return a, b


@pytest.mark.parametrize("p,n_a,n_b,n_common", [
    (8, 5, 8, 3), (8, 0, 4, 0), (1024, 700, 1024, 490),
    (1024, 1024, 311, 200)])
def test_sorted_intersect_matches_jax_kernel(p, n_a, n_b, n_common):
    a, b = _key_rows(p, n_a, n_b, n_common, seed=p + n_a)
    sel, rank, merged = si_ref.sorted_intersect(torch.from_numpy(a)[None],
                                                torch.from_numpy(b)[None])
    j_sel, j_rank, j_kh, j_kl = jax_sorted_intersect(*_lanes(a), *_lanes(b),
                                                     impl="pallas")
    assert np.array_equal(sel[0].numpy(), np.asarray(j_sel))
    assert np.array_equal(rank[0].numpy(), np.asarray(j_rank))
    kh, kl = _lanes(merged[0].numpy())
    assert np.array_equal(kh, np.asarray(j_kh))     # pads included
    assert np.array_equal(kl, np.asarray(j_kl))
    assert int(sel.sum()) == n_common


def _pairs(seed, npairs=3, max_n=90):
    g = np.random.default_rng(seed)
    senders, receivers, seeds = [], [], []
    for _ in range(npairs):
        a = np.unique(g.integers(0, 2 ** 55, g.integers(0, max_n),
                                 dtype=np.int64))
        b = np.unique(g.integers(0, 2 ** 55, g.integers(0, max_n),
                                 dtype=np.int64))
        k = min(len(a), len(b)) // 2
        if k:
            b = np.unique(np.concatenate([a[:k], b]))
        senders.append(a)
        receivers.append(b)
        seeds.append((int(g.integers(0, 2 ** 32)),
                      int(g.integers(0, 2 ** 32))))
    return senders, receivers, seeds


@pytest.mark.parametrize("sort", ["host", "device"])
def test_oprf_round_matches_numpy_and_jax(sort):
    senders, receivers, seeds = _pairs(seed=1)
    rnd = engine.oprf_round(senders, receivers, seeds,
                            options=AlignOptions(device="cpu", sort=sort))
    assert rnd.dispatches == (1 if sort == "device" else 2)
    jrnd = jax_engine.oprf_round(senders, receivers, seeds,
                                 options=JaxAlign(impl="pallas",
                                                  sort="host"))
    for got, j, s, r in zip(rnd.intersections, jrnd.intersections,
                            senders, receivers):
        assert got.dtype == np.int64
        assert np.array_equal(got, np.intersect1d(s, r))
        assert np.array_equal(got, j)


def test_match_round_matches_numpy():
    senders, receivers, _ = _pairs(seed=2)
    r_tags = [ids & engine.TAG_MASK for ids in receivers]
    s_tags = [ids & engine.TAG_MASK for ids in senders]
    rnd = engine.match_round(r_tags, receivers, s_tags, options=CPU)
    assert rnd.dispatches == 1
    for got, s, r in zip(rnd.intersections, senders, receivers):
        assert np.array_equal(got, np.intersect1d(s, r))


@pytest.mark.parametrize("sort", ["host", "device"])
def test_empty_sets_and_empty_batch(sort):
    empty = np.array([], np.int64)
    opts = AlignOptions(device="cpu", sort=sort)
    rnd = engine.oprf_round([empty, np.arange(5, dtype=np.int64)],
                            [np.arange(5, dtype=np.int64), empty],
                            [(1, 2), (3, 4)], options=opts)
    assert [i.size for i in rnd.intersections] == [0, 0]
    assert engine.oprf_round([], [], [], options=opts).intersections == []


def _id_sets(m, n, seed):
    from repro.data.synthetic import make_id_universe
    return make_id_universe(m, n, 0.6, seed=seed)[0]


@pytest.mark.parametrize("topology", ["tree", "path", "star"])
@pytest.mark.parametrize("protocol,backend", [("oprf", "device"),
                                              ("rsa", "device"),
                                              ("oprf", "host")])
def test_mpsi_stats_match_jax(topology, protocol, backend):
    sets = _id_sets(5, 40 if protocol == "rsa" else 300, seed=3)
    got = mpsi.MPSI[topology](sets, options=AlignOptions(
        protocol=protocol, psi_backend=backend, device="cpu"))
    want = jax_mpsi.MPSI[topology](sets, options=JaxAlign(
        protocol=protocol, psi_backend=backend, impl="pallas"))
    assert np.array_equal(got.intersection, want.intersection)
    for f in ("rounds", "total_bytes", "total_messages", "schedule",
              "device_dispatches"):
        assert getattr(got, f) == getattr(want, f), f
    assert len(got.per_round_seconds) == len(want.per_round_seconds)


def test_tree_mpsi_unoptimized_schedule_matches_jax():
    sets = _id_sets(6, 200, seed=4)
    opts = dict(protocol="oprf", psi_backend="device")
    got = mpsi.tree_mpsi(sets, volume_aware=False, use_he=False,
                         options=AlignOptions(device="cpu", **opts))
    want = jax_mpsi.tree_mpsi(sets, volume_aware=False, use_he=False,
                              options=JaxAlign(impl="pallas", **opts))
    assert np.array_equal(got.intersection, want.intersection)
    assert got.schedule == want.schedule
    assert got.total_bytes == want.total_bytes
