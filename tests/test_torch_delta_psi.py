"""Streaming delta-PSI, ported: ``TagIndex``, ``DeltaMPSI`` and its
stream into the scoring engine, against the reference.

The port runs its device backend on the CPU (the merge kernel's plain
version through ``psi/engine.match_round``/``union_merge``); the
reference runs its host backend (``np.intersect1d``/``np.sort`` — its
device backend with ``impl="ref"`` would run the vmapped merge ref, which
aborts XLA on this jax, ROADMAP §3 R1).  After every delta of a seeded
sequence the aligned set, the update and the ``DeltaStats`` byte,
message, round and compaction counters must be equal, and the aligned
set must equal the plain intersection of the parties' current sets."""
from functools import reduce

import numpy as np
import pytest
import torch

from repro.config import AlignOptions as JaxAlign
from repro.core.mpsi import tree_mpsi as jax_tree_mpsi
from repro.psi import DeltaMPSI as JaxDeltaMPSI
from repro.psi import TagIndex as JaxTagIndex
from repro.psi import run_psi as jax_run_psi
from repro_torch.config import AlignOptions
from repro_torch.core.splitnn import SplitNNConfig, init_splitnn
from repro_torch.psi import (AlignedDelta, DeltaMPSI, DeltaStats, TagIndex,
                             run_psi)
from repro_torch.psi.delta import MAX_ID
from repro_torch.serve.vfl import VFLScoringEngine

torch.set_num_threads(1)
DEVICE = AlignOptions(protocol="oprf", psi_backend="device", device="cpu")
COUNTERS = ("deltas_applied", "rounds", "total_bytes", "total_messages",
            "compactions", "bootstrap_bytes")


def _sets(g, m, n, universe):
    return [g.choice(universe, size=n, replace=False).astype(np.int64)
            for _ in range(m)]


def _delta(g, current, universe, k):
    pool = np.setdiff1d(np.arange(universe, dtype=np.int64), current)
    joins = g.choice(pool, size=min(k, pool.size), replace=False)
    leaves = (g.choice(current, size=min(k, current.size), replace=False)
              if current.size else np.empty(0, np.int64))
    return joins, leaves


@pytest.mark.parametrize("m,max_runs,use_he", [(3, 2, False), (4, 3, False),
                                               (5, 8, True)])
def test_delta_mpsi_matches_reference_every_step(m, max_runs, use_he):
    g = np.random.default_rng(m * 10 + max_runs)
    universe = 2500
    sets = _sets(g, m, 600, universe)
    got = DeltaMPSI(sets, options=DEVICE, use_he=use_he, max_runs=max_runs)
    want = JaxDeltaMPSI(sets, options=JaxAlign(protocol="oprf",
                                               psi_backend="host"),
                        use_he=use_he, max_runs=max_runs)
    assert np.array_equal(got.aligned, want.aligned)
    for step in range(10):
        party = step % m
        joins, leaves = _delta(g, got.party_set(party), universe,
                               k=int(g.integers(0, 60)))
        if step == 4:
            leaves = np.concatenate([leaves, joins[:3]])   # join wins
        dg = got.apply_delta(party, joins, leaves)
        dw = want.apply_delta(party, joins, leaves)
        assert isinstance(dg, AlignedDelta) and dg.version == dw.version
        for f in ("added", "removed", "aligned"):
            assert np.array_equal(getattr(dg, f), getattr(dw, f)), f
        assert np.array_equal(got.aligned, reduce(
            np.intersect1d, [got.party_set(q) for q in range(m)]))
        for f in COUNTERS:
            assert getattr(got.stats, f) == getattr(want.stats, f), (step, f)
        for q in range(m):
            assert np.array_equal(got.party_set(q), want.party_set(q))
    assert got.stats.device_dispatches > got.bootstrap.device_dispatches
    full = jax_tree_mpsi([got.party_set(q) for q in range(m)],
                         use_he=False, options=JaxAlign(protocol="oprf",
                                                        psi_backend="host"))
    assert np.array_equal(got.aligned, full.intersection)


def test_tag_index_matches_reference_under_compaction():
    """The device compaction (``union_merge``) against the reference's
    host merge: the same runs, run for run, at every step."""
    g = np.random.default_rng(1)
    base = g.choice(1500, size=400, replace=False)
    got = TagIndex(base, options=DEVICE, max_runs=2)
    want = JaxTagIndex(base, options=JaxAlign(psi_backend="host"),
                       max_runs=2)
    cur = np.sort(base.astype(np.int64))
    for _ in range(12):
        joins, leaves = _delta(g, cur, 1500, k=30)
        got.apply_delta(joins, leaves)
        want.apply_delta(joins, leaves)
        cur = want.materialize()
        assert len(got.runs) == len(want.runs)
        for a, b in zip(got.runs, want.runs):
            assert a.dtype == b.dtype == np.uint64 and np.array_equal(a, b)
        assert np.array_equal(got.materialize(), cur)
        probe = g.integers(0, 1500, 50)
        assert np.array_equal(got.contains(probe), want.contains(probe))
    assert got.compactions == want.compactions > 0
    got.compact(full=True)
    assert len(got.runs) == 1 and np.array_equal(got.materialize(), cur)


def test_tag_index_edges():
    idx = TagIndex([1, 2, 3], options=DEVICE, max_runs=8)
    idx.apply_delta(joins=[4], leaves=[2])
    idx.apply_delta(joins=[2], leaves=[4, 9])
    assert idx.contains([1, 2, 3, 4, 9]).tolist() == [True, True, True,
                                                      False, False]
    empty = TagIndex([], options=DEVICE)
    empty.apply_delta(joins=[7], leaves=[7])
    assert empty.materialize().tolist() == [7] and len(empty) == 1
    with pytest.raises(ValueError):
        TagIndex([MAX_ID])
    with pytest.raises(ValueError):
        TagIndex([1], max_runs=1)


def test_delta_mpsi_takes_only_port_options():
    sets = [np.arange(10), np.arange(5, 15)]
    with pytest.raises(TypeError):
        DeltaMPSI(sets, options=JaxAlign())
    with pytest.raises(ValueError):
        DeltaMPSI(sets[:1], options=DEVICE)
    dm = DeltaMPSI(sets, options=DEVICE, use_he=False)
    with pytest.raises(ValueError):
        dm.apply_delta(2, joins=[1])
    assert isinstance(dm.stats, DeltaStats)
    assert dm.stats.to_dict()["deltas_applied"] == 0


def test_stream_into_scoring_engine():
    """The live aligned set drives the engine's eligible population:
    seeded at wiring time, patched by every delta."""
    cfg = SplitNNConfig(model="lr", n_classes=2, seed=0)
    eng = VFLScoringEngine(init_splitnn(cfg, [3, 2], device="cpu"), cfg,
                           slots=4)
    g = np.random.default_rng(5)
    sets = _sets(g, 3, 200, 600)
    dm = DeltaMPSI(sets, options=DEVICE, use_he=False, max_runs=2)
    seen = []
    dm.subscribe(seen.append)
    dm.stream_into(eng)
    assert np.array_equal(eng._eligible, dm.aligned)
    for step in range(4):
        dm.apply_delta(step % 3, *_delta(g, dm.party_set(step % 3), 600, 20))
        assert np.array_equal(eng._eligible, dm.aligned)
    assert [d.version for d in seen] == [1, 2, 3, 4]
    assert eng.stats.eligible_updates == 5


@pytest.mark.parametrize("topology", ["tree", "path", "star"])
def test_run_psi_matches_reference(topology):
    g = np.random.default_rng(7)
    sets = _sets(g, 4, 300, 900)
    got = run_psi(sets, topology=topology, options=DEVICE, use_he=False)
    want = jax_run_psi(sets, topology=topology, use_he=False,
                       options=JaxAlign(protocol="oprf", psi_backend="host"))
    assert np.array_equal(got.intersection, want.intersection)
    for f in ("rounds", "total_bytes", "total_messages", "schedule"):
        assert getattr(got, f) == getattr(want, f), f
    with pytest.raises(ValueError, match="topology"):
        run_psi(sets, topology="ring")
