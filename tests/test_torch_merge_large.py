"""K8: the merge past the reference's single-pass bound.  The reference
splits the merge into multi-pass cross/local stages for P >
``SINGLE_PASS_MAX_P`` (``sorted_intersect_tiled``); the port runs one
merge-path kernel at every P, so the port's merge plain version must give
the tiled schedule's (sel, rank, merged) bit for bit.  Held here against
the tiled reference run in interpret mode at the shrunk chunk/tile splits
of tests/test_psi_kernels.py (which make small inputs take several cross
passes), at a real P past the bound against numpy, and ``union_merge``
against the reference's."""
import numpy as np
import pytest
import torch

from repro.config import AlignOptions as JaxAlign
from repro.kernels.sorted_intersect import ref as jax_si_ref
from repro.kernels.sorted_intersect.kernel import \
    SINGLE_PASS_MAX_P as JAX_SINGLE_PASS_MAX_P
from repro.kernels.sorted_intersect.kernel import sorted_intersect_tiled
from repro.kernels.sorted_intersect.ops import next_pow2
from repro.psi import engine as jax_engine
from repro_torch.config import AlignOptions
from repro_torch.kernels.sorted_intersect import ref as si_ref
from repro_torch.kernels.sorted_intersect.kernel import SINGLE_PASS_MAX_P
from repro_torch.kernels.sorted_intersect.ops import sorted_intersect
from repro_torch.psi import engine
from test_torch_psi import _join, _lanes

torch.set_num_threads(1)


def _sides(na, nb, seed):
    """Two unique sorted tag sets, half of the smaller one common."""
    g = np.random.default_rng(seed)
    a = np.unique(g.integers(0, 2 ** 60, na, dtype=np.int64))
    b = np.unique(g.integers(0, 2 ** 60, max(nb, 1), dtype=np.int64))[:nb]
    k = min(len(a), len(b)) // 2
    if k:
        b = np.unique(np.concatenate([a[:k], b]))
    return a, b


def _keys(tags, origin, pad, p):
    row = np.full(p, pad, np.int64)
    row[:len(tags)] = (np.sort(tags) << 1) | origin
    return row


@pytest.mark.parametrize("na,nb,chunk_p,tile", [
    (100, 80, 16, 8), (1000, 900, 64, 16), (5, 3, 8, 8), (300, 300, 256, 64)])
def test_merge_matches_tiled_reference(na, nb, chunk_p, tile):
    a, b = _sides(na, nb, seed=na + nb)
    p = next_pow2(max(len(a), len(b)))
    ka = _keys(a, 1, si_ref.PAD_A64, p)
    kb = _keys(b, 0, si_ref.PAD_B64, p)
    j_sel, j_rank, j_kh, j_kl = sorted_intersect_tiled(
        *_lanes(ka), *_lanes(kb), interpret=True, chunk_p=chunk_p, tile=tile)
    sel, rank, merged = si_ref.sorted_intersect(torch.from_numpy(ka)[None],
                                                torch.from_numpy(kb)[None])
    assert np.array_equal(sel[0].numpy(), np.asarray(j_sel))
    assert np.array_equal(rank[0].numpy(), np.asarray(j_rank))
    assert np.array_equal(merged[0].numpy(), _join(j_kh, j_kl))


def test_single_pass_bound_is_the_reference_s():
    assert SINGLE_PASS_MAX_P == JAX_SINGLE_PASS_MAX_P == 1 << 18


@pytest.mark.parametrize("pairs", [1, 3])
def test_merge_past_the_bound_matches_numpy(pairs):
    """P = 2^19, the YP rounds' and delta probes' pad length: every
    pair's decoded intersection is numpy's, and the merged keys are the
    sorted union (with the pads last)."""
    p = 2 * SINGLE_PASS_MAX_P
    rows_a, rows_b, sides = [], [], []
    for i in range(pairs):
        a, b = _sides(300_000 - 7_000 * i, 280_000, seed=i)
        rows_a.append(_keys(a, 1, si_ref.PAD_A64, p))
        rows_b.append(_keys(b, 0, si_ref.PAD_B64, p))
        sides.append((a, b))
    sel, rank, merged = sorted_intersect(
        torch.from_numpy(np.stack(rows_a)), torch.from_numpy(np.stack(rows_b)))
    for i, (a, b) in enumerate(sides):
        s = sel[i].numpy().astype(bool)
        got = np.sort(a)[rank[i].numpy()[s] - 1]
        assert np.array_equal(got, np.intersect1d(a, b))
        keys = merged[i].numpy()
        valid = keys[keys >= 0]
        assert np.array_equal(valid, np.sort(np.concatenate(
            [(a << 1) | 1, b << 1])))


@pytest.mark.parametrize("na,nb", [(0, 5), (7, 0), (300, 500), (2000, 1500)])
def test_union_merge_matches_reference(na, nb):
    """The compaction primitive: the merged full keys ``(tag << 1) |
    origin`` with the padding stripped, against the reference's Pallas
    path (interpret mode)."""
    g = np.random.default_rng(na * 7 + nb)
    pool = g.choice(2 ** 40, na + nb + 50, replace=False).astype(np.uint64)
    a = np.sort(pool[:na])
    b = np.sort(np.concatenate([pool[na:na + nb - nb // 3],
                                a[:nb // 3]])) if nb else pool[:0]
    got = engine.union_merge(a, b, options=AlignOptions(device="cpu"))
    want = jax_engine.union_merge(a, b, options=JaxAlign(impl="pallas"))
    assert got.dtype == np.uint64 and want.dtype == np.uint64
    assert np.array_equal(got, want)
    assert got.size == na + len(b)


def test_union_merge_origin_marks_side():
    got = engine.union_merge(np.array([2, 5, 9], np.uint64),
                             np.array([1, 5, 7], np.uint64),
                             options=AlignOptions(device="cpu"))
    assert got.tolist() == [2, 5, 10, 11, 14, 19]
    assert jax_si_ref.VALID_LIMIT == 0x80000000   # the pads' top bit
