"""The port's data generators and threefry PRNG against the reference:
datasets, partitions and id universes byte-identical; threefry keys,
splits, randint and uniform bitwise equal to ``jax.random``; the
``choice(p=)`` index equal at the seeds used."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.data.synthetic import DATASETS, make_dataset, make_id_universe
from repro.data.vertical import partition_features
from repro_torch import rng
from repro_torch.data import synthetic as pt_synth
from repro_torch.data import vertical as pt_vert


@pytest.mark.parametrize("name", sorted(DATASETS))
def test_datasets_byte_identical(name):
    assert (dataclasses.astuple(pt_synth.DATASETS[name])
            == dataclasses.astuple(DATASETS[name]))
    for seed in (0, 3):
        x, y = make_dataset(DATASETS[name], seed=seed, n_override=257)
        px, py = pt_synth.make_dataset(pt_synth.DATASETS[name], seed=seed,
                                       n_override=257)
        assert x.dtype == px.dtype and y.dtype == py.dtype
        assert x.tobytes() == px.tobytes() and y.tobytes() == py.tobytes()
        for clients, props in ((3, None), (4, [1, 2, 3, 4])):
            ref = partition_features(x, y, clients, proportions=props)
            got = pt_vert.partition_features(px, py, clients,
                                             proportions=props)
            assert ref.feature_slices == got.feature_slices
            for a, b in zip(ref.client_features, got.client_features):
                assert a.tobytes() == b.tobytes()
            assert ref.labels.tobytes() == got.labels.tobytes()


@pytest.mark.parametrize("n_per_client,overlap",
                         [(300, 0.7), ([120, 400, 90], 0.5)])
def test_id_universe_identical(n_per_client, overlap):
    m = 3
    sets, core = make_id_universe(m, n_per_client, overlap, seed=5)
    psets, pcore = pt_synth.make_id_universe(m, n_per_client, overlap,
                                             seed=5)
    assert np.array_equal(core, pcore)
    for a, b in zip(sets, psets):
        assert a.dtype == b.dtype and np.array_equal(a, b)


SEEDS = list(range(0, 40)) + [17 * 2 + 1, 2 ** 31 - 1, 123456789]


@pytest.mark.parametrize("block", range(4))
def test_threefry_matches_jax_random(block):
    for seed in SEEDS[block::4]:
        jkey = jax.random.PRNGKey(seed)
        key = rng.PRNGKey(seed)
        assert np.array_equal(np.asarray(jkey), key)
        for num in (2, 3, 7):
            assert np.array_equal(np.asarray(jax.random.split(jkey, num)),
                                  rng.split(key, num))
        for maxval in (1, 2, 14, 441, 49_000, 70_001, 2 ** 20 + 3):
            want = int(jax.random.randint(jkey, (), 0, maxval))
            assert rng.randint(key, 0, maxval) == want, (seed, maxval)
        u = np.float32(jax.random.uniform(jkey))
        assert np.float32(rng.uniform(key)).tobytes() == u.tobytes()


def test_threefry_chained_stream_matches_kmeanspp_schedule():
    """The k-means++ key schedule: split, randint, then split + choice
    per centroid, for the coreset's per-client seeds seed + 17*m."""
    for seed in (0, 17, 34):
        jkey, key = jax.random.PRNGKey(seed), rng.PRNGKey(seed)
        for step in range(14):
            jkey, jsub = jax.random.split(jkey)
            key, sub = rng.split(key)
            assert np.array_equal(np.asarray(jsub), sub)
            assert np.float32(jax.random.uniform(jsub)) == rng.uniform(sub)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_choice_index_matches_jax(seed):
    g = np.random.default_rng(seed)
    for n in (5, 300, 4000):
        p = g.random(n).astype(np.float32) ** 3
        p[g.random(n) < 0.2] = 0.0
        p /= p.sum()
        jkey = jax.random.PRNGKey(seed * 101 + n)
        want = int(jax.random.choice(jkey, n, p=jnp.asarray(p)))
        got = rng.choice_index(rng.PRNGKey(seed * 101 + n), p)
        cum = np.cumsum(p, dtype=np.float32)
        r = cum[-1] * (np.float32(1) - rng.uniform(rng.PRNGKey(
            seed * 101 + n)))
        assert got == want, (
            f"seed {seed} n {n}: port picked {got}, jax {want}; draw "
            f"{r!r} vs cumsum boundaries {cum[max(want - 1, 0):want + 1]!r}")
