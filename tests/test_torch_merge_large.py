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
from repro_torch.kernels.sorted_intersect.kernel import (
    GRID_ROWS, ITEMS, SINGLE_PASS_MAX_P, SMEM_MAX, SMS, THREADS,
    merge_geometry, merge_smem_bytes, sorted_intersect_cuda)
from repro_torch.kernels.sorted_intersect.ops import sorted_intersect
from repro_torch.psi import engine
from test_torch_psi import _join, _key_rows, _lanes

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


# ------------------------------------------------- the kernel's tile design
#
# csrc/sorted_intersect.cu runs only on the card.  ``_merge_path`` mirrors
# its merge_path_kernel step by step (the co-ranks of a tile's two
# boundaries by the warp's ballot, the windows in aligned 16-byte words
# and single keys, and the halo, each thread's
# shared-memory co-rank and serial merge, the padded staging and the
# 16-byte or scalar stores), so the tile design is held to the plain
# version here; the card holds the kernel itself to it (chip_smoke.py's
# merge rows).

def _padded(w: int) -> int:
    return w + (w >> 3)          # sorted_intersect.cu's padded()


def _warp_co_rank(a, b, d, p):
    """warp_co_rank: 32 probes a round, their ballot a prefix."""
    lo, hi = max(d - p, 0), min(d, p)
    rounds = 0
    while lo < hi:
        step = (hi - lo + 31) >> 5
        before = [x < hi and a[x] <= b[d - x - 1]
                  for x in (lo + lane * step for lane in range(32))]
        c = sum(before)
        assert before == [True] * c + [False] * (32 - c)
        if c == 0:
            hi = lo
        else:
            last = lo + (c - 1) * step
            lo, hi = last + 1, min(last + step, hi)
        rounds += 1
    return lo, rounds


def _stage_windows(ga, apar, gb, bpar, threads):
    """Step 2's loads: (win, aoff, boff), the shared window buffer as the
    CTA fills it from A's window ``ga`` (its first key's address parity
    ``apar``) and B's ``gb``: each key keeps its place in a 16-byte word,
    each body moves as aligned words, an odd head or tail as one key."""
    la, lb = len(ga), len(gb)
    win = np.full(threads * ITEMS + 2, 0xDEAD, np.uint64)  # TILE/2 + 1 words
    written = np.zeros(len(win), int)
    aoff = apar
    boff = aoff + la + ((aoff + la + bpar) & 1)
    ha, hb = min(aoff, la), min(bpar, lb)
    wa_words = (la - ha) >> 1
    w_words = wa_words + ((lb - hb) >> 1)
    assert w_words <= threads * ITEMS // 2        # ITEMS / 2 words a thread
    for w in range(w_words):
        src, par, h, off, x = ((ga, apar, ha, aoff, w) if w < wa_words else
                               (gb, bpar, hb, boff, w - wa_words))
        dst = off + h + 2 * x
        assert dst % 2 == 0 and (par + h) % 2 == 0   # both sides aligned
        win[dst:dst + 2] = src[h + 2 * x:h + 2 * x + 2]
        written[dst:dst + 2] += 1
    singles = [(aoff, ga, 0)] if ha else []
    if (la - ha) & 1:
        singles.append((aoff + la - 1, ga, la - 1))
    if hb:
        singles.append((boff, gb, 0))
    if (lb - hb) & 1:
        singles.append((boff + lb - 1, gb, lb - 1))
    for at, src, e in singles:
        win[at] = src[e]
        written[at] += 1
    assert written.max(initial=0) <= 1 and written.sum() == la + lb
    return win, aoff, boff


def _tile(wa, wb, halo, d0, i0, la, lb, n, threads, tile):
    """A tile's step 3 (each thread's merge) and the staging of step 4."""
    st_m = np.zeros(2 * _padded(tile // 2), np.uint64)
    st_r = np.zeros(4 * _padded(tile // 4), np.int32)
    st_s = np.zeros(4 * _padded(tile // 4), np.int32)
    for t in range(threads):
        dl = t * ITEMS
        merged = [np.uint64(0)] * ITEMS
        rank, sel = [0] * ITEMS, [0] * ITEMS
        if dl < n:
            lo, hi = max(dl - lb, 0), min(dl, la)
            while lo < hi:
                m = (lo + hi) >> 1
                if wa[m] <= wb[dl - m - 1]:
                    lo = m + 1
                else:
                    hi = m
            i, k = lo, dl - lo
            if dl == 0:
                prev = halo
            elif i == 0:
                prev = wb[k - 1]
            elif k == 0:
                prev = wa[i - 1]
            else:
                prev = max(wa[i - 1], wb[k - 1])
            has_prev = d0 + dl > 0
            for it in range(min(ITEMS, n - dl)):
                take_a = k >= lb or (i < la and wa[i] <= wb[k])
                key = wa[i] if take_a else wb[k]
                i, k = (i + 1, k) if take_a else (i, k + 1)
                sel[it] = int(take_a and has_prev
                              and prev == key ^ np.uint64(1)
                              and key < np.uint64(1 << 63))
                rank[it], merged[it] = i0 + i, key
                prev, has_prev = key, True
        for q in range(ITEMS // 2):
            w = _padded(t * (ITEMS // 2) + q)
            st_m[2 * w:2 * w + 2] = merged[2 * q:2 * q + 2]
        for q in range(ITEMS // 4):
            w = _padded(t * (ITEMS // 4) + q)
            st_r[4 * w:4 * w + 4] = rank[4 * q:4 * q + 4]
            st_s[4 * w:4 * w + 4] = sel[4 * q:4 * q + 4]
    return st_m, st_r, st_s


def _merge_path(a: np.ndarray, b: np.ndarray, threads: int):
    """(sel, rank, merged, the most co-rank rounds) as merge_path_kernel
    computes them with CTAs of ``threads`` threads."""
    pairs, p = a.shape
    tile = threads * ITEMS
    au, bu = a.view(np.uint64), b.view(np.uint64)
    out_m = np.zeros(pairs * 2 * p, np.uint64)
    out_r = np.full(pairs * 2 * p, -7, np.int32)
    out_s = np.full(pairs * 2 * p, -7, np.int32)
    most = 0
    for y in range(pairs):
        for x in range(-(-2 * p // tile)):
            d0 = x * tile
            n = min(tile, 2 * p - d0)
            (i0, r0), (i1, r1) = (_warp_co_rank(au[y], bu[y], d, p)
                                  for d in (d0, d0 + n))
            most = max(most, r0, r1)
            la, k0 = i1 - i0, d0 - i0
            lb = n - la
            win, aoff, boff = _stage_windows(
                au[y, i0:i1], (y * p + i0) & 1, bu[y, k0:k0 + lb],
                (y * p + k0) & 1, threads)
            halo = max(au[y, i0 - 1] if i0 else np.uint64(0),
                       bu[y, k0 - 1] if k0 else np.uint64(0))
            st_m, st_r, st_s = _tile(win[aoff:aoff + la], win[boff:boff + lb],
                                     halo, d0, i0, la, lb, n, threads, tile)
            g0 = y * 2 * p + d0
            if n == tile and g0 % 4 == 0:
                for w in range(tile // 2):
                    out_m[g0 + 2 * w:g0 + 2 * w + 2] = \
                        st_m[2 * _padded(w):2 * _padded(w) + 2]
                for w in range(tile // 4):
                    out_r[g0 + 4 * w:g0 + 4 * w + 4] = \
                        st_r[4 * _padded(w):4 * _padded(w) + 4]
                    out_s[g0 + 4 * w:g0 + 4 * w + 4] = \
                        st_s[4 * _padded(w):4 * _padded(w) + 4]
            else:
                for e in range(n):
                    out_m[g0 + e] = st_m[2 * _padded(e >> 1) + (e & 1)]
                    out_r[g0 + e] = st_r[4 * _padded(e >> 2) + (e & 3)]
                    out_s[g0 + e] = st_s[4 * _padded(e >> 2) + (e & 3)]
    shape = (pairs, 2 * p)
    return (out_s.reshape(shape), out_r.reshape(shape),
            out_m.view(np.int64).reshape(shape), most)


# (P, [(n_a, n_b, n_common, layout) a pair]): the tile and co-rank edges
MERGE_PATH_CASES = {
    "p8-5-8-3": (8, [(5, 8, 3, "random")]),
    "p8-0-4-0": (8, [(0, 4, 0, "random")]),
    "p8-8-8-8": (8, [(8, 8, 8, "identical")]),
    "a-all-pads": (1024, [(0, 1000, 0, "random")]),
    "b-all-pads": (1024, [(1000, 0, 0, "random")]),
    "a-below-b": (1024, [(1024, 1024, 0, "a_below_b")]),
    "b-below-a": (1024, [(900, 1024, 0, "b_below_a")]),
    "identical": (1024, [(1024, 1024, 1024, "identical")]),
    "alternating": (2048, [(2048, 2048, 0, "alternating")]),
    "3-pairs": (2048, [(1433, 1433, 1003, "random"),
                       (2048, 2000, 1500, "random"),
                       (17, 1, 1, "random")]),
    "p-odd-3-pairs": (1001, [(1001, 700, 490, "random"),
                             (3, 1001, 2, "random"),
                             (600, 600, 600, "identical")]),
}


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("case", sorted(MERGE_PATH_CASES))
def test_merge_path_design_matches_plain_version(case, threads):
    """The kernel's tile design, mirrored in Python, is bitwise the plain
    version at every edge: P = 8 under one tile, one side all pads,
    disjoint sides either way round, every key common, every tile
    boundary inside a run, pairs that are not a power of two, and an odd
    P whose second pair starts off 16 bytes (the scalar stores)."""
    p, fills = MERGE_PATH_CASES[case]
    rows = [_key_rows(p, *f[:3], seed=i + p, layout=f[3])
            for i, f in enumerate(fills)]
    a = np.stack([r[0] for r in rows])
    b = np.stack([r[1] for r in rows])
    sel, rank, merged, most = _merge_path(a, b, threads)
    want = si_ref.sorted_intersect(torch.from_numpy(a), torch.from_numpy(b))
    assert np.array_equal(sel, want[0].numpy())
    assert np.array_equal(rank, want[1].numpy())
    assert np.array_equal(merged, want[2].numpy())
    assert int(sel.sum()) == sum(f[2] for f in fills)
    assert most <= 3          # 32-fold a round: 3 rounds at P <= 2,048


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("apar,bpar", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_window_loads_place_each_key_once(apar, bpar, threads):
    """The windows' loads at each address parity of A's and B's first key:
    every key of both windows lands once, at its window's offset, the
    16-byte words aligned on both sides, inside TILE/2 + 1 words; from
    empty windows to a full tile."""
    tile = threads * ITEMS
    rng = np.random.default_rng(apar * 2 + bpar)
    sizes = [(0, 0), (1, 0), (0, 1), (1, 1), (2, 3), (3, 2), (0, tile),
             (tile, 0), (tile - 1, 1), (1, tile - 1), (tile // 2 - 1,
             tile // 2 + 1)] + [tuple(rng.integers(0, tile // 2, 2))
                                for _ in range(8)]
    for la, lb in sizes:
        ga = rng.integers(0, 2 ** 62, la).astype(np.uint64)
        gb = rng.integers(0, 2 ** 62, lb).astype(np.uint64)
        win, aoff, boff = _stage_windows(ga, apar, gb, bpar, threads)
        assert aoff == apar and boff % 2 == bpar and boff >= aoff + la
        assert np.array_equal(win[aoff:aoff + la], ga)
        assert np.array_equal(win[boff:boff + lb], gb)
    assert merge_smem_bytes(threads) >= 16 * (tile // 2 + 1)


@pytest.mark.parametrize("threads", THREADS)
def test_staging_layout_is_free_of_bank_conflicts(threads):
    """A 16-byte shared access is served 8 threads at a time, conflict
    free where their words differ mod 8: the blocked writes (a thread's
    merged slots in ITEMS/2 words, its ranks and flags in ITEMS/4) and
    the striped reads, with one word of padding after every 8."""
    for per in (ITEMS // 2, ITEMS // 4):
        for q in range(per):
            for t0 in range(0, threads, 8):
                banks = {_padded(t * per + q) % 8 for t in range(t0, t0 + 8)}
                assert len(banks) == 8
        for w0 in range(0, threads * per, 8):
            assert len({_padded(w) % 8 for w in range(w0, w0 + 8)}) == 8
    # unpadded, the blocked writes would conflict 4-way and 2-way
    assert len({(t * (ITEMS // 2)) % 8 for t in range(8)}) == 2


@pytest.mark.parametrize("pairs", [1, 3, 9])
@pytest.mark.parametrize("p", [8, 2 ** 10, 2 ** 17, 2 ** 19, 2 ** 20,
                               2 ** 21])
def test_merge_geometry_covers_every_slot(pairs, p):
    """The tiles cover every merged slot of every pair once, a CTA's
    shared memory fits, and every index inside a pair is int32."""
    geom = merge_geometry(pairs, p)
    assert geom.tile == geom.threads * ITEMS
    assert geom.tile & (geom.tile - 1) == 0
    assert (geom.tiles - 1) * geom.tile < 2 * p <= geom.tiles * geom.tile
    starts = np.arange(geom.tiles) * geom.tile
    ends = np.minimum(starts + geom.tile, 2 * p)
    assert starts[0] == 0 and ends[-1] == 2 * p
    assert np.array_equal(starts[1:], ends[:-1])
    assert geom.rows == pairs                 # every pair has a grid row
    assert geom.ctas == geom.tiles * pairs
    assert geom.smem_bytes <= SMEM_MAX
    assert geom.tiles * geom.tile < 2 ** 31
    if (pairs, p) == (1, 2 ** 17):            # the HI rounds
        assert geom.ctas >= SMS and geom.tile <= 1024


def test_merge_geometry_picks_tiles_and_grid_rows():
    """The largest tile that still gives two CTAs an SM: 512 slots for the
    HI rounds (P = 2^17), 2,048 for the YP rounds (2^19) and the delta
    probe's nine pairs; a pair count past the grid's rows loops."""
    assert [merge_smem_bytes(t) for t in THREADS] == [9232, 36880]
    assert [merge_geometry(pairs, p).threads for pairs, p in (
        (1, 8), (1, 2 ** 17), (1, 2 ** 18), (1, 2 ** 19), (9, 2 ** 19),
        (3, 2 ** 17))] == [64, 64, 64, 256, 256, 256]
    assert merge_geometry(70_000, 8).rows == GRID_ROWS


def test_kernel_wrapper_refuses_what_it_cannot_launch():
    """``sorted_intersect_cuda`` checks shapes and the int32 rank before
    the device, and refuses CPU tensors (the plain version is
    ``impl="ref"``); ``ops.sorted_intersect(impl="kernel")`` too."""
    a, b = _key_rows(8, 5, 8, 3, seed=1)
    a, b = torch.from_numpy(a)[None], torch.from_numpy(b)[None]
    with pytest.raises(ValueError, match="CUDA"):
        sorted_intersect_cuda(a, b)
    with pytest.raises(ValueError, match="CUDA"):
        sorted_intersect(a, b, impl="kernel")
    with pytest.raises(ValueError, match=r"\(pairs, P\)"):
        sorted_intersect_cuda(a, b[:, :4])
    with pytest.raises(ValueError, match=r"\(pairs, P\)"):
        sorted_intersect_cuda(a[0], b[0])
    big = torch.empty((1, 2 ** 30), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="too large"):
        sorted_intersect_cuda(big, big)
