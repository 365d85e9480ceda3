"""The CUDA k-means assign kernel's launch geometry and shared-memory
layout (``kmeans_assign/kernel.py``, ``csrc/kmeans_assign.cu``), which
the CPU can check without the card: every row of every client falls to
one CTA, tile and thread exactly once, in ascending tiles; the shared
memory of the padded centroid block; the CTA fits shared memory; the
wrapper hands the launcher its geometry and refuses CPU tensors.  The
kernel's arithmetic is held against its plain version (and K3's bits)
on the card by ``chip_smoke.py``; the plain version against the
reference by ``tests/test_torch_kmeans.py``."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.kmeans_assign import kernel

# (M, N, K, d): the HI and YP coreset fits, a YP minibatch build's end, a
# single row, ragged tiles, fewer rows than R·THREADS, d = 1, widths past
# the compiled ones (64-row tiles at d = 500, 32-row ones at d = 900), and
# centroid blocks so large that R = 4's 512-row tile is cut to 256 and 128
GEOMETRY_CASES = [(3, 49_000, 14, 11), (3, 249_900, 12, 30),
                  (1, 357_000, 12, 30), (1, 1, 3, 5), (2, 127, 7, 2),
                  (1, 129, 1, 1), (1, 1000, 12, 30), (3, 4097, 40, 64),
                  (2, 3000, 9, 130), (1, 300, 16, 300), (1, 200, 16, 500),
                  (1, 100, 4, 900), (5, 77, 4, 16), (1, 513, 2, 17),
                  (1, 5000, 1300, 32), (2, 700, 2600, 20)]


def _thread_rows(geo, n):
    """Mirror of the kernel's cut: for every (CTA, tile, thread, i) the
    row it assigns, in the order of CTAs, then tiles."""
    rows = []
    for first, end in geo.row_ranges(n):
        for t0 in range(first, end, geo.tile):
            size = min(geo.tile, end - t0)
            for i in range(geo.r):
                for t in range(kernel.THREADS):
                    row = i * kernel.THREADS + t
                    if row < size:
                        rows.append((t0, t0 + row))
    return rows


@pytest.mark.parametrize("m,n,k,d", GEOMETRY_CASES)
def test_assign_geometry_covers_every_row_once(m, n, k, d):
    """Each CTA an equal contiguous range of rows (the last ragged), its
    tiles ascending from its first row, each tile's rows shared out as
    t + i·THREADS; together every row exactly once.  At most as many
    CTAs as the card holds at once, and the CTA fits shared memory."""
    geo = kernel.geometry(m, n, k, d)
    assert geo.r == (4 if d <= kernel.D_FIXED else 1)
    assert geo.tile % 4 == 0 and geo.tile <= kernel.THREADS * geo.r
    assert geo.rows_per_cta % 32 == 0
    ranges = geo.row_ranges(n)
    assert len(ranges) == geo.ctas
    assert all(a < b for a, b in ranges), "a CTA without rows"
    assert ranges[0][0] == 0 and ranges[-1][1] == n
    assert all(b == a2 for (_, b), (a2, _) in zip(ranges, ranges[1:]))
    assert all(b - a == geo.rows_per_cta for a, b in ranges[:-1])
    covered = _thread_rows(geo, n)
    starts = [t0 for t0, _ in covered]
    assert starts == sorted(starts)          # ascending tiles
    got = np.array([row for _, row in covered])
    assert np.array_equal(np.sort(got), np.arange(n))
    # every CTA of a call resident at once, per_sm an SM
    assert 1 <= geo.per_sm <= kernel.CTAS_PER_SM[geo.r]
    assert m * geo.ctas <= kernel.SMS * geo.per_sm
    assert geo.smem_bytes == kernel.smem_bytes(geo.tile, k, d)
    assert geo.smem_bytes <= kernel.SMEM_MAX
    assert geo.per_sm * (geo.smem_bytes + 1024) <= kernel.SMEM_SM


@pytest.mark.parametrize("m,n,d", [(3, 49_000, 11), (3, 249_900, 30),
                                   (1, 357_000, 30)])
def test_assign_geometry_fills_the_card(m, n, d):
    """At the main path's shapes every SM holds as many CTAs as it can,
    each with the same rows but the last one a client."""
    geo = kernel.geometry(m, n, 12, d)
    slots = kernel.SMS * geo.per_sm
    assert slots * 9 // 10 < m * geo.ctas <= slots


@pytest.mark.parametrize("k,d", [(14, 11), (12, 30), (1, 1), (3, 4),
                                 (40, 64), (9, 130)])
def test_padded_centroid_layout(k, d):
    """``smem_bytes`` sets aside the padded centroid block the kernel
    stages (centroid q's value j at q·round4(d) + j, zero pads, so each
    centroid starts on a 16-byte word) and the round4(K) norms after it;
    the layout itself is held on the card by K5's bitwise match with K3
    at widths with pads (``chip_smoke.py``)."""
    dp = (d + 3) & ~3
    block = kernel.smem_bytes(128, k, d) - kernel.smem_bytes(128, 0, d)
    assert block == 4 * (k * dp + ((k + 3) & ~3))


@pytest.mark.parametrize("k", [14, 12, 40])
@pytest.mark.parametrize("d", [11, 30, 64, 130, 300])
def test_assign_smem_fits(k, d):
    """The CTA of every geometry at these widths and centroid counts fits
    the 232,448 bytes a CTA may use, with its whole tile buffer."""
    geo = kernel.geometry(3, 249_900, k, d)
    assert geo.smem_bytes <= kernel.SMEM_MAX == 232_448
    assert geo.smem_bytes >= 4 * geo.tile * d


@pytest.mark.parametrize("m,n,k,d", GEOMETRY_CASES[:6])
def test_assign_launches_its_geometry(monkeypatch, m, n, k, d):
    """The wrapper passes the launcher (m, n, k, k_real, d) and the
    geometry (r, tile, rows_per_cta, ctas), with as many arguments as
    the C launcher takes, counts one launch, and returns (M, N) int32 and
    f32 outputs."""
    calls = []

    def fake_function(name, symbol, n_pointers, n_ints, n_floats=0):
        def launch(*args):
            assert len(args) == n_pointers + n_ints + n_floats + 1, symbol
            calls.append((symbol, args[n_pointers:n_pointers + n_ints]))
            return 0
        return launch

    monkeypatch.setattr(kernel.build, "require_cuda", lambda *a, **kw: None)
    monkeypatch.setattr(kernel.build, "function", fake_function)
    monkeypatch.setattr(kernel.build, "launch",
                        lambda fn, device, *args: fn(*args, 0))
    before = kernel.build.LAUNCHES["kmeans_assign"]
    try:
        assign, sqd = kernel.kmeans_assign_cuda(torch.zeros((m, n, d)),
                                                torch.zeros((m, k, d)))
    finally:
        launched = kernel.build.LAUNCHES["kmeans_assign"] - before
        kernel.build.LAUNCHES["kmeans_assign"] = before
    assert launched == 1
    assert assign.shape == sqd.shape == (m, n)
    assert assign.dtype == torch.int32 and sqd.dtype == torch.float32
    ((symbol, ints),) = calls
    assert symbol == "kmeans_assign_launch"
    geo = kernel.geometry(m, n, k, d)
    assert ints == (m, n, k, k, d, geo.r, geo.tile, geo.rows_per_cta,
                    geo.ctas)


def test_assign_refuses_cpu_tensors():
    """No fallback: the CUDA wrapper raises on CPU tensors."""
    with pytest.raises(ValueError, match="CUDA"):
        kernel.kmeans_assign_cuda(torch.zeros((1, 8, 3)),
                                  torch.zeros((1, 2, 3)))
