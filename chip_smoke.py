"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each printing JSON lines:

1. device   — the card's name and power limit (nvidia-smi) and torch's name.
2. build    — compiles every CUDA kernel of the slice from
              ``src/repro_torch/kernels/csrc`` (one nvcc per source, all
              at once) into ``build/repro_torch_ext/``.
3. kernels  — each kernel against its plain PyTorch version on the card,
              at the shapes the main paths give it (K6 on 2×2^17 ids, K7
              at P=2^17 with ~70% overlap, K3/K5 at M=3, N=49,000, d=11,
              K=14, K1 at an eval block M=3, B=512, d=11, o=8 and at lr's
              o=1, K2 at a train step of 700 seeded rows with duplicates
              out of a (3, 49,000, 11) slab); median time over 20 launches with
              CUDA events beside the plain version, the library yardstick
              and the bound.  Integer outputs must match bit for bit; an
              assignment may differ only on a near tie (best/second-best
              d² margin <= 1e-4·(1+d²)); counts are exact; sums within
              rtol=1e-5 of Σ|p| of the float64 sums of the kernel's own
              assignment; sqd within 1e-5 + 1e-5·(‖p‖²+‖c‖²) of the plain
              version, the size of the terms the f32 formula cancels.
              K1/K2 outputs within 1e-6 + 1e-5·(Σ_k|x_k w_k| + |b|) of the
              plain version, and K2 bitwise equal to K1 on the gathered
              rows.
4. pipeline — ``run_pipeline(model="knn")`` at the paper's full HI size
              (70,000 train / 30,000 test rows, 3 clients, k=14,
              25 iterations, OPRF on the device) for ``treecss`` and
              ``starall``, once with the kernels (launch counts set to 0
              just before and read just after each run) and once with
              ``impl="ref"``; intersections and MPSIStats counters must be
              identical and accuracy within 0.002.  Coreset indices must be
              identical, or else the two coreset fits, run side by side
              from the same k-means++ centroids, must first part at a step
              where every differing assignment is a near tie (the f32
              distances of the kernel and of cuBLAS sum in other orders);
              two kernel fits must give the same bits.
5. train    — ``run_pipeline`` for the SplitNN jobs at full HI with the
              paper's Table-2 settings (batches of max(8, 70,000 // 100) =
              700 rows, lr 0.05 for lr and 0.01 for mlp, k=14, OPRF on the
              device): treecss × {mlp, lr} and starall × mlp (49,000 rows,
              70 steps an epoch), each to the 200-epoch cap or convergence,
              each traced, with the kernels and with every plain version.
              MPSI and n_train must be identical, steps and comm_bytes too
              unless the convergence window stopped at another epoch
              (reported), the loss at the last common epoch within rtol
              1e-3 (within 1e-3 of the first epoch's loss where the two
              coreset fits parted at a near tie), accuracy within 0.005
              and in (0.5, 1]; K2 launches = train steps, K1 launches =
              eval batches, no launch in the plain runs.
6. serve    — ``VFLScoringEngine(slots=64)`` over the 30,000 HI test rows
              as seeded requests of 1-256 rows with the treecss-mlp params:
              outputs within tolerance of ``score_partition``, ServeStats
              equal between the kernel and plain engines, K1 launches =
              dispatches.
7. profile  — spans, device busy share and top device ops of one traced
              full-HI treecss run, k-NN and mlp.

The line before the last two is the ``{"kernels": [...]}`` summary; the
line before the last is nvidia-smi's name and power limit; the last line
is ``{"ok": true, "device": {...}}``.  Any failure raises and exits
non-zero without that line.  The script never imports jax or ``repro``.
Full results also go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 peak bandwidth
F32_FLOPS = 67e12              # H100 SXM f32 outside the tensor cores
SEED = 0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``reps`` calls, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def profile_device(fn, reps: int = 20):
    """torch.profiler over ``reps`` calls of ``fn``: ({kernel name: device
    ms per call}, total device ms per call or None where the profiler
    sees no device time, wall ms per call of the profiled window)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    per_name = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = getattr(ev, "cuda_time_total", 0)
        if ev.device_type == torch.autograd.DeviceType.CUDA and t > 0:
            per_name[ev.key] = t / 1e3 / reps
    return (per_name, sum(per_name.values()) if per_name else None,
            wall_ms)


def kernel_device_ms(fn, marks):
    """Device time per call of the launches whose names contain one of
    ``marks`` (the CUDA kernels of the wrapper, without the small torch
    ops around them); None where the profiler sees no device time."""
    per_name, _, _ = profile_device(fn)
    hits = [t for k, t in per_name.items() if any(m in k for m in marks)]
    return sum(hits) if hits else None


def bound(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------ kernel phase

def near_tie_rows(points, cents, assign_a, assign_b):
    """Rows whose assignments differ, and whether each is a near tie
    (best/second-best d² margin <= 1e-4·(1+d²), in float64)."""
    p = points.double()
    c = cents.double()
    d = ((p[:, :, None, :] - c[:, None, :, :]) ** 2).sum(-1)
    two = torch.topk(d, 2, dim=-1, largest=False).values
    margin = two[..., 1] - two[..., 0]
    tie = margin <= 1e-4 * (1 + two[..., 0])
    diff = assign_a != assign_b
    return int(diff.sum()), int((diff & ~tie).sum()), float(
        margin[diff].min()) if bool(diff.any()) else None


def check_close(name, got, want, scale, rtol=1e-5, atol=1e-5) -> float:
    """|got - want| <= atol + rtol * scale, where ``scale`` is the size of
    the terms the f32 arithmetic combined (‖p‖² + ‖c‖² for a distance
    that cancels them; Σ|p| for a cluster sum), which bounds the
    rounding error of either summation order."""
    err = (got.double() - want.double()).abs()
    lim = atol + rtol * scale.double()
    if bool((err > lim).any()):
        raise AssertionError(f"{name}: max abs err {float(err.max())} "
                             f"exceeds atol={atol} rtol={rtol}")
    return float(err.max()) if err.numel() else 0.0


def sqd_scale(points, cents, assign):
    """‖p‖² + ‖c_assign‖² per row: the size of the terms d² cancels."""
    c2 = (cents * cents).sum(-1)
    return (points * points).sum(-1) + torch.gather(c2, 1, assign.long())


def kernel_phase(dev):
    from repro_torch.kernels.kmeans_assign import ref as ka_ref
    from repro_torch.kernels.kmeans_assign.kernel import kmeans_assign_cuda
    from repro_torch.kernels.kmeans_update import ref as ku_ref
    from repro_torch.kernels.kmeans_update.kernel import kmeans_update_cuda
    from repro_torch.kernels.psi_prf import ref as prf_ref
    from repro_torch.kernels.psi_prf.kernel import prf_tags_cuda
    from repro_torch.kernels.sorted_intersect import ref as si_ref
    from repro_torch.kernels.sorted_intersect.kernel import \
        sorted_intersect_cuda
    from repro_torch.kernels.sorted_intersect.ops import (PAD_A64, PAD_B64,
                                                          next_pow2)

    rng = np.random.default_rng(SEED)
    rows = []

    # K6 psi_prf: both sides of one pair, P = 2^17 ids each
    p = next_pow2(70_000)
    ids = torch.from_numpy(rng.integers(0, 2 ** 62, (2, p),
                                        dtype=np.int64)).to(dev)
    seeds = torch.from_numpy(rng.integers(0, 2 ** 32, (2, 2),
                                          dtype=np.int64)).to(dev)
    got, want = prf_tags_cuda(ids, seeds), prf_ref.prf_tags(ids, seeds)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("psi_prf: kernel and plain version differ "
                             f"on {int((got != want).sum())} tags")
    b_ms, b_by = bound(ids.numel() * 16, ids.numel() * 52)
    rows.append(dict(
        name="psi_prf", route="cuda",
        source="src/repro_torch/kernels/csrc/psi_prf.cu",
        replaces="src/repro/kernels/psi_prf/kernel.py:35",
        max_abs_err=0.0,
        ms=cuda_ms(lambda: prf_tags_cuda(ids, seeds)),
        device_ms=kernel_device_ms(lambda: prf_tags_cuda(ids, seeds),
                                   ["prf_kernel"]),
        plain_ms=cuda_ms(lambda: prf_ref.prf_tags(ids, seeds)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=[2, p]))

    # K7 sorted_intersect: one pair at P = 2^17, 70,000 keys a side,
    # ~70% of them common
    n_side, n_common = 70_000, 49_000
    tags = np.unique(rng.integers(0, 2 ** 62, 3 * n_side, dtype=np.int64))
    tags = rng.permutation(tags)
    common = tags[:n_common]
    ta = np.sort(np.concatenate([common, tags[n_common:n_side]]))
    tb = np.sort(np.concatenate([common,
                                 tags[n_side:2 * n_side - n_common]]))
    a = np.full((1, p), PAD_A64, np.int64)
    b = np.full((1, p), PAD_B64, np.int64)
    a[0, :len(ta)] = (ta << 1) | 1
    b[0, :len(tb)] = tb << 1
    a, b = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
    got, want = sorted_intersect_cuda(a, b), si_ref.sorted_intersect(a, b)
    torch.cuda.synchronize()
    for part, g, w in zip(("sel", "rank", "merged"), got, want):
        if not torch.equal(g, w):
            raise AssertionError(f"sorted_intersect {part}: kernel and "
                                 f"plain version differ on "
                                 f"{int((g != w).sum())} slots")
    if int(got[0].sum()) != n_common:
        raise AssertionError("sorted_intersect: wrong intersection size")
    ab = torch.cat([a, b], 1)
    b_ms, b_by = bound(2 * p * 8 + 2 * p * 16, 2 * p * 4 * 18)
    rows.append(dict(
        name="sorted_intersect", route="cuda",
        source="src/repro_torch/kernels/csrc/sorted_intersect.cu",
        replaces="src/repro/kernels/sorted_intersect/kernel.py:73",
        max_abs_err=0.0,
        ms=cuda_ms(lambda: sorted_intersect_cuda(a, b)),
        device_ms=kernel_device_ms(lambda: sorted_intersect_cuda(a, b),
                                   ["merge_kernel"]),
        plain_ms=cuda_ms(lambda: si_ref.sorted_intersect(a, b)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: torch.sort(ab, dim=1)),
        shape=[1, p]))

    # K3 / K5 at the coreset fit's shapes: the HI clients' slices (11/11/10
    # columns zero-padded to 11) of 49,000 rows, 14 centroids from the rows
    from repro_torch.kernels.padding import stack_padded
    tr, _ = hi_partitions()
    m, n, d, k = 3, 49_000, 11, 14
    pts = stack_padded([torch.from_numpy(f[:n]).to(dev)
                        for f in tr.client_features], n, d)
    cents = pts[:, torch.from_numpy(rng.choice(n, k, replace=False)).to(
        dev)].contiguous()
    ops_assign = m * n * (2 * d + k * (2 * d + 3) + k)
    io_bytes = m * n * d * 4 + m * k * d * 4 + m * n * 8

    ga, gs, gsum, gcnt = kmeans_update_cuda(pts, cents)
    wa, ws, wsum, wcnt = ku_ref.kmeans_update(pts, cents)
    torch.cuda.synchronize()
    n_diff, n_bad, min_margin = near_tie_rows(pts, cents, ga, wa)
    if n_bad:
        raise AssertionError(f"kmeans_update: {n_bad} assignments differ "
                             "beyond a near tie")
    same = ga == wa
    err = check_close("kmeans_update sqd", gs[same], ws[same],
                      sqd_scale(pts, cents, wa)[same])
    # counts and sums of the rows the kernel assigned, exactly (float64)
    seg = (torch.arange(m, device=dev)[:, None] * k + ga.long()).reshape(-1)
    rows_f64 = pts.double().reshape(m * n, d)
    exact = torch.zeros((m * k, d), dtype=torch.float64, device=dev
                        ).index_add_(0, seg, rows_f64).view(m, k, d)
    abs_sums = torch.zeros((m * k, d), dtype=torch.float64, device=dev
                           ).index_add_(0, seg, rows_f64.abs()).view(m, k, d)
    if not torch.equal(gcnt.double(), torch.bincount(
            seg, minlength=m * k).view(m, k).double()):
        raise AssertionError("kmeans_update: counts are not exact")
    check_close("kmeans_update sums (vs float64)", gsum, exact, abs_sums)
    if n_diff == 0:     # a near-tie row moves one point between clusters
        if not torch.equal(gcnt, wcnt):
            raise AssertionError("kmeans_update: counts differ")
        err = max(err, float((gsum - wsum).abs().max()))
    b_ms, b_by = bound(io_bytes + m * k * (d + 1) * 4,
                       ops_assign + m * n * d)
    rows.append(dict(
        name="kmeans_update", route="cuda",
        source="src/repro_torch/kernels/csrc/kmeans_update.cu",
        replaces="src/repro/kernels/kmeans_update/kernel.py:94",
        max_abs_err=err, assign_mismatch=n_diff,
        min_mismatch_margin=min_margin,
        ms=cuda_ms(lambda: kmeans_update_cuda(pts, cents)),
        device_ms=kernel_device_ms(lambda: kmeans_update_cuda(pts, cents),
                                   ["update_kernel", "reduce_kernel"]),
        plain_ms=cuda_ms(lambda: ku_ref.kmeans_update(pts, cents)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=[m, n, d, k]))

    ga, gs = kmeans_assign_cuda(pts, cents)
    wa, ws = ka_ref.kmeans_assign(pts, cents)
    torch.cuda.synchronize()
    n_diff, n_bad, min_margin = near_tie_rows(pts, cents, ga, wa)
    if n_bad:
        raise AssertionError(f"kmeans_assign: {n_bad} assignments differ "
                             "beyond a near tie")
    same = ga == wa
    err = check_close("kmeans_assign sqd", gs[same], ws[same],
                      sqd_scale(pts, cents, wa)[same])
    b_ms, b_by = bound(io_bytes, ops_assign)
    rows.append(dict(
        name="kmeans_assign", route="cuda",
        source="src/repro_torch/kernels/csrc/kmeans_assign.cu",
        replaces="src/repro/kernels/kmeans_assign/kernel.py:39",
        max_abs_err=err, assign_mismatch=n_diff,
        min_mismatch_margin=min_margin,
        ms=cuda_ms(lambda: kmeans_assign_cuda(pts, cents)),
        device_ms=kernel_device_ms(lambda: kmeans_assign_cuda(pts, cents),
                                   ["assign_kernel"]),
        plain_ms=cuda_ms(lambda: ka_ref.kmeans_assign(pts, cents)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: torch.cdist(pts, cents).argmin(-1)),
        shape=[m, n, d, k]))
    rows += bottom_kernel_rows(dev, tr, rng)
    for r in rows:
        emit({"phase": "kernel", **r})
    return rows


def bottom_kernel_rows(dev, tr, rng):
    """K1 at the eval block (and at lr's o=1 without ReLU), K2 at a
    full-HI train step, each against its plain version; K2 bitwise
    against K1 on the gathered rows."""
    from repro_torch.kernels.padding import stack_padded
    from repro_torch.kernels.splitnn_bottom import ref as sb_ref
    from repro_torch.kernels.splitnn_bottom.kernel import (
        splitnn_bottom_cuda, splitnn_bottom_gather_cuda)

    m, n, d = 3, 49_000, 11
    slab = stack_padded([torch.from_numpy(f[:n]).to(dev)
                         for f in tr.client_features], n, d)
    g = lambda *shape, scale=1.0: (torch.from_numpy(rng.normal(
        size=shape).astype(np.float32)) * scale).to(dev)

    def scale_of(x, w, b):          # Σ_k |x_k w_k| + |b|, per output
        return torch.bmm(x.abs(), w.abs()) + b.abs()[:, None, :]

    def row(name, x, w, b, relu, idx=None, **extra):
        o = w.shape[2]
        xg = x if idx is None else x.index_select(1, idx).contiguous()
        if idx is None:
            call = lambda: splitnn_bottom_cuda(x, w, b, relu)
        else:
            call = lambda: splitnn_bottom_gather_cuda(idx, x, w, b, relu)
        got, want = call(), sb_ref.splitnn_bottom(xg, w, b, relu)
        torch.cuda.synchronize()
        err = check_close(name, got, want, scale_of(xg, w, b), rtol=1e-5,
                          atol=1e-6)
        if idx is not None:
            k1 = splitnn_bottom_cuda(xg, w, b, relu)
            torch.cuda.synchronize()
            if not torch.equal(got, k1):
                raise AssertionError("splitnn_bottom_gather: K2 differs "
                                     "from K1 on the gathered rows")
            extra["k2_equals_k1_bitwise"] = True
        bsz = xg.shape[1]
        rows_read = bsz if idx is None else int(torch.unique(idx).numel())
        nbytes = 4 * (m * rows_read * d + m * d * o + m * o + m * bsz * o
                      + (0 if idx is None else bsz))
        b_ms, b_by = bound(nbytes, m * bsz * o * (2 * d + 2))
        bb = b[:, None, :]
        return dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/splitnn_bottom.cu",
            max_abs_err=err, ms=cuda_ms(call),
            device_ms=kernel_device_ms(call, ["bottom_kernel"]),
            plain_ms=cuda_ms(lambda: sb_ref.splitnn_bottom(x, w, b, relu,
                                                           idx)),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=cuda_ms(lambda: torch.baddbmm(bb, xg, w)),
            library="torch.baddbmm on the same (gathered) operands, "
                    "without the ReLU",
            shape=[m, bsz, d, o], relu=relu, **extra)

    eval_x = slab[:, :512].contiguous()
    w8, b8 = g(m, d, 8, scale=d ** -0.5), g(m, 8, scale=0.1)
    w1, b1 = g(m, d, 1, scale=0.1 * d ** -0.5), g(m, 1, scale=0.1)
    idx = torch.from_numpy(rng.integers(0, n, 700).astype(np.int32)).to(dev)
    idx[1::50] = idx[0]                      # duplicates, as a schedule
    return [
        row("splitnn_bottom", eval_x, w8, b8, True,
            replaces="src/repro/kernels/splitnn_bottom/kernel.py:40"),
        row("splitnn_bottom", eval_x, w1, b1, False, check_only="lr",
            replaces="src/repro/kernels/splitnn_bottom/kernel.py:40"),
        row("splitnn_bottom_gather", slab, w8, b8, True, idx=idx,
            replaces="src/repro/kernels/splitnn_bottom/kernel.py:141"),
    ]


# ---------------------------------------------------------- pipeline phase

def hi_partitions():
    """The paper's HI job as ``benchmarks/common.dataset_partitions(
    quick=False)`` builds it: 100,000 × 32, 70/30 split, 3 clients."""
    from repro_torch.data.synthetic import DATASETS, make_dataset
    from repro_torch.data.vertical import partition_features
    spec = DATASETS["HI"]
    x, y = make_dataset(spec, seed=SEED)
    order = np.random.default_rng(SEED + 1).permutation(spec.n_instances)
    n_tr = int(spec.n_instances * 0.7)
    return (partition_features(x[order[:n_tr]], y[order[:n_tr]], 3),
            partition_features(x[order[n_tr:]], y[order[n_tr:]], 3))


def fit_divergence(tr, dev):
    """Where the kernel and plain-version coreset fits of the HI clients
    part: both start from the same k-means++ centroids and run Lloyd
    steps side by side; at the first step whose assignments differ,
    every differing row must be a near tie of the kernel's centroids.
    Also: two kernel fits give the same bits (no atomics)."""
    from repro_torch import rng
    from repro_torch.config import AlignOptions
    from repro_torch.core.kmeans import (kmeans_fit, kmeans_pp_init,
                                         lloyd_step, pad_masks)
    from repro_torch.core.treecss import _align
    from repro_torch.kernels.padding import stack_padded

    aligned, *_ = _align(tr, "tree", seed=SEED, align=AlignOptions(
        protocol="oprf", psi_backend="device", device=dev))
    feats = aligned.client_features
    ns = [f.shape[0] for f in feats]
    pts = stack_padded([torch.from_numpy(f).to(dev) for f in feats],
                       max(ns), max(f.shape[1] for f in feats))
    keys = np.stack([rng.PRNGKey(SEED + 17 * i) for i in range(len(feats))])
    fits = [kmeans_fit(keys, pts, 14, impl="kernel", n_valid=ns)
            for _ in range(2)]
    if not all(torch.equal(a, b) for a, b in zip(*fits)):
        raise AssertionError("two kernel fits differ")
    valid, n_pad = pad_masks(max(ns), ns, dev)
    ck = cr = kmeans_pp_init(keys, pts, 14, ns)
    for it in range(25):
        nk, ak = lloyd_step(pts, ck, valid, n_pad, "kernel")
        nr, ar = lloyd_step(pts, cr, valid, n_pad, "ref")
        if not torch.equal(ak, ar):
            n_diff, n_bad, margin = near_tie_rows(pts, ck, ak, ar)
            out = dict(first_divergence_step=it, rows=n_diff,
                       beyond_near_tie=n_bad, min_margin=margin)
            break
        ck, cr = nk, nr
    else:
        out = dict(first_divergence_step=None, rows=0, beyond_near_tie=0,
                   min_margin=None)
    emit({"phase": "fit_divergence", **out})
    if out["beyond_near_tie"]:
        raise AssertionError("kernel and plain fits part beyond a near tie")
    return out


def pipeline_phase(dev):
    from repro_torch.config import AlignOptions, EngineOptions
    from repro_torch.core.splitnn import SplitNNConfig
    from repro_torch.core.treecss import run_pipeline
    from repro_torch.kernels.build import LAUNCHES, reset_launches

    tr, te = hi_partitions()
    drive = lambda variant, impl: run_pipeline(
        tr, te, SplitNNConfig(model="knn", n_classes=2), variant=variant,
        clusters_per_client=14, kmeans_impl=impl, seed=SEED, knn_k=5,
        options=EngineOptions(device=dev),
        align=AlignOptions(protocol="oprf", psi_backend="device", impl=impl))
    # one untimed drive first: lazy CUDA module loading and cuBLAS set-up
    # would otherwise land in the first timed run's stage walls
    drive("treecss", "kernel")
    runs = {}
    for variant in ("treecss", "starall"):
        for impl in ("kernel", "ref"):
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rep = drive(variant, impl)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(LAUNCHES)
            row = dict(phase="pipeline", variant=variant, impl=impl,
                       n_align=int(rep.mpsi.intersection.shape[0]),
                       n_train=rep.n_train, metric=rep.metric,
                       rounds=rep.mpsi.rounds,
                       comm_bytes=rep.mpsi.total_bytes,
                       dispatches=rep.mpsi.device_dispatches,
                       align_wall_s=rep.align_wall_seconds,
                       coreset_wall_s=rep.coreset_wall_seconds,
                       knn_wall_s=rep.train_wall_seconds,
                       total_wall_s=wall, launches=launches)
            emit(row)
            runs[variant, impl] = (rep, row)

    # the fits may part at a near tie of two f32 summation orders;
    # anything else is a fault (fit_divergence raises)
    divergence = fit_divergence(tr, dev)
    for variant in ("treecss", "starall"):
        (rk, row_k), (rr, row_r) = runs[variant, "kernel"], runs[variant,
                                                                 "ref"]
        if not np.array_equal(rk.mpsi.intersection, rr.mpsi.intersection):
            raise AssertionError(f"{variant}: intersections differ")
        for f in ("rounds", "total_bytes", "total_messages", "schedule",
                  "device_dispatches"):
            if getattr(rk.mpsi, f) != getattr(rr.mpsi, f):
                raise AssertionError(f"{variant}: MPSIStats.{f} differs")
        if (rk.coreset is not None and not np.array_equal(
                rk.coreset.indices, rr.coreset.indices)
                and divergence["first_divergence_step"] is None):
            raise AssertionError(f"{variant}: coreset indices differ")
        if abs(rk.metric - rr.metric) > 0.002:
            raise AssertionError(f"{variant}: accuracy {rk.metric} vs "
                                 f"{rr.metric}")
        if any(row_r["launches"].values()):
            raise AssertionError(f"{variant}: impl='ref' launched kernels")
        if not 0.5 < rk.metric <= 1.0 or rk.n_train <= 0:
            raise AssertionError(f"{variant}: implausible result")
    on_path = {"treecss": ("psi_prf", "sorted_intersect", "kmeans_update",
                           "kmeans_assign"),
               "starall": ("psi_prf", "sorted_intersect")}
    for variant, names in on_path.items():
        launches = runs[variant, "kernel"][1]["launches"]
        missing = [k for k in names if launches[k] == 0]
        if missing:
            raise AssertionError(f"{variant}: kernels {missing} were not "
                                 "launched on the main path")
    rows = [r for _, r in runs.values()] + [divergence]
    return runs["treecss", "kernel"][1]["launches"], rows


# (variant, model, lr, max_epochs): the paper's 200-epoch cap for all
# three; starall × mlp (70 steps an epoch) stops at convergence well
# inside the script's time (PERF.md §4)
TRAIN_JOBS = (("treecss", "mlp", 0.01, 200), ("treecss", "lr", 0.05, 200),
              ("starall", "mlp", 0.01, 200))


def train_cfg(model, lr, n_rows, max_epochs):
    """The paper's Table-2 SplitNN settings for HI
    (``benchmarks/table2_framework.py``)."""
    from repro_torch.core.splitnn import SplitNNConfig
    return SplitNNConfig(model=model, n_classes=2, lr=lr,
                         batch_size=max(8, n_rows // 100),
                         max_epochs=max_epochs, seed=SEED)


def drive_split(tr, te, dev, variant, cfg, impl, trace=None):
    from repro_torch.config import AlignOptions, EngineOptions
    from repro_torch.core.treecss import run_pipeline
    return run_pipeline(
        tr, te, cfg, variant=variant, clusters_per_client=14,
        kmeans_impl=impl, seed=SEED,
        options=EngineOptions(device=dev, bottom_impl=impl, trace=trace),
        align=AlignOptions(protocol="oprf", psi_backend="device", impl=impl))


def train_phase(dev):
    """The SplitNN jobs at full HI, kernels against plain versions."""
    from repro_torch.kernels.build import LAUNCHES, reset_launches

    tr, te = hi_partitions()
    n_eval_batches = -(-te.n_samples // 512)
    # untimed, both models: first use of autograd, of each model's
    # GEMM shapes and of pinned host memory would otherwise land in the
    # first timed run of that model
    for model in ("mlp", "lr"):
        drive_split(tr, te, dev, "treecss",
                    train_cfg(model, 0.01, tr.n_samples, 2), None)
    runs, rows = {}, []
    for variant, model, lr, epochs in TRAIN_JOBS:
        cfg = train_cfg(model, lr, tr.n_samples, epochs)
        for impl in ("kernel", "ref"):
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rep = drive_split(tr, te, dev, variant, cfg, impl, trace=True)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(LAUNCHES)
            row = dict(phase="train", variant=variant, model=model,
                       impl=impl, max_epochs=cfg.max_epochs,
                       batch_size=cfg.batch_size, lr=lr,
                       n_align=int(rep.mpsi.intersection.shape[0]),
                       n_train=rep.n_train, metric=rep.metric,
                       epochs=rep.train.epochs, steps=rep.train.steps,
                       final_loss=rep.train.losses[-1],
                       comm_bytes=rep.train.comm_bytes,
                       align_wall_s=rep.align_wall_seconds,
                       coreset_wall_s=rep.coreset_wall_seconds,
                       train_wall_s=rep.train_wall_seconds,
                       train_engine_s=rep.train.train_seconds,
                       ms_per_step=rep.train.train_seconds * 1e3
                       / rep.train.steps,
                       eval_wall_s=rep.tracer.total_seconds(
                           "pipeline.serve"),
                       total_wall_s=wall, launches=launches)
            emit(row)
            runs[variant, model, impl] = (rep, row)
            rows.append(row)
    for variant, model, _, _ in TRAIN_JOBS:
        (rk, row_k), (rr, row_r) = (runs[variant, model, "kernel"],
                                    runs[variant, model, "ref"])
        tag = f"{variant}/{model}"
        if not np.array_equal(rk.mpsi.intersection, rr.mpsi.intersection):
            raise AssertionError(f"{tag}: intersections differ")
        if rk.n_train != rr.n_train:
            raise AssertionError(f"{tag}: n_train {rk.n_train} vs "
                                 f"{rr.n_train}")
        common = min(rk.train.epochs, rr.train.epochs)
        if rk.train.epochs == rr.train.epochs:
            if (rk.train.steps, rk.train.comm_bytes) != (
                    rr.train.steps, rr.train.comm_bytes):
                raise AssertionError(f"{tag}: steps or comm_bytes differ")
        else:
            emit({"phase": "train_note", "job": tag,
                  "epochs_kernel": rk.train.epochs,
                  "epochs_ref": rr.train.epochs,
                  "note": "the convergence window stopped at another "
                          "epoch"})
        # the loss at the last common epoch within rtol 1e-3; where the
        # two coreset fits parted at a near tie (fit_divergence) the runs
        # train on other weights, and a converged loss four orders below
        # its start is then held within 1e-3 of the first epoch's loss
        same_data = rk.coreset is None or (
            np.array_equal(rk.coreset.indices, rr.coreset.indices)
            and np.array_equal(rk.coreset.weights, rr.coreset.weights))
        row_k["same_train_data"] = same_data
        lk, lr_ = rk.train.losses[common - 1], rr.train.losses[common - 1]
        lim = 1e-3 * (abs(lr_) if same_data else rr.train.losses[0])
        if abs(lk - lr_) > lim:
            raise AssertionError(f"{tag}: loss {lk} vs {lr_} at epoch "
                                 f"{common} (same train data: {same_data})")
        if abs(rk.metric - rr.metric) > 0.005:
            raise AssertionError(f"{tag}: accuracy {rk.metric} vs "
                                 f"{rr.metric}")
        if not 0.5 < rk.metric <= 1.0:
            raise AssertionError(f"{tag}: implausible accuracy {rk.metric}")
        if any(row_r["launches"].values()):
            raise AssertionError(f"{tag}: the plain run launched kernels")
        launched = row_k["launches"]
        if launched["splitnn_bottom_gather"] != rk.train.steps:
            raise AssertionError(f"{tag}: K2 launched "
                                 f"{launched['splitnn_bottom_gather']} "
                                 f"times in {rk.train.steps} train steps")
        if launched["splitnn_bottom"] != n_eval_batches:
            raise AssertionError(f"{tag}: K1 launched "
                                 f"{launched['splitnn_bottom']} times for "
                                 f"{n_eval_batches} eval batches")
    return runs, rows


def serve_phase(dev, params, cfg):
    """The test set as seeded requests through ``VFLScoringEngine``,
    kernel and plain engines, against ``score_partition``."""
    from repro_torch.kernels.build import LAUNCHES, reset_launches
    from repro_torch.serve.vfl import VFLScoringEngine, score_partition

    _, te = hi_partitions()
    feats = te.client_features
    want = torch.from_numpy(score_partition(params, cfg, te, block_b=512))
    g = np.random.default_rng(SEED + 2)
    bounds, s = [], 0
    while s < te.n_samples:
        e = min(s + int(g.integers(1, 257)), te.n_samples)
        bounds.append((s, e))
        s = e
    requests = [(rid, [f[a:b] for f in feats])
                for rid, (a, b) in enumerate(bounds)]
    out = {}
    for impl in ("kernel", "ref"):
        eng = VFLScoringEngine(params, cfg, slots=64, bottom_impl=impl)
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.score_requests(requests)
        wall = time.perf_counter() - t0
        got = torch.from_numpy(np.concatenate([res[r] for r in
                                               range(len(bounds))]))
        out[impl] = (eng.stats, dict(LAUNCHES), wall, got)
    # the K1 tolerance, with each output's term magnitudes carried
    # through the top layers: (|a|·|w1| + |b1|)·|w2| + |b2|
    p = {k: v.detach().double().abs().cpu() for k, v in params["top"].items()}
    acts = [torch.from_numpy(np.abs(f)).double() @ bp["w"].double().abs().cpu()
            + bp["b"].double().abs().cpu()
            for f, bp in zip(feats, params["bottoms"])]
    scale = ((torch.cat(acts, 1) @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"])
    rows = []
    for impl, (stats, launches, wall, got) in out.items():
        err = check_close(f"serve[{impl}] vs score_partition", got, want,
                          scale, rtol=1e-5, atol=1e-6)
        row = dict(phase="serve", impl=impl, requests=len(bounds),
                   rows=te.n_samples, wall_s=wall, max_abs_err=err,
                   stats=stats.to_dict(), launches=launches)
        emit(row)
        rows.append(row)
    (sk, lk, _, _), (sr, _, _, _) = out["kernel"], out["ref"]
    fields = sk.CONTRACT_FIELDS
    if [getattr(sk, f) for f in fields] != [getattr(sr, f) for f in fields]:
        raise AssertionError("serve: ServeStats differ between engines")
    if lk["splitnn_bottom"] != sk.dispatches:
        raise AssertionError(f"serve: K1 launched {lk['splitnn_bottom']} "
                             f"times in {sk.dispatches} dispatches")
    if any(out["ref"][1].values()):
        raise AssertionError("serve: the plain engine launched kernels")
    return rows


def profile_phase(dev):
    """Where the time of one full-HI treecss run goes: the obs spans of a
    traced run (host wall per stage), then, under torch.profiler, the
    device time and the top device ops."""
    from repro_torch.config import AlignOptions, EngineOptions
    from repro_torch.core.splitnn import SplitNNConfig
    from repro_torch.core.treecss import run_pipeline

    tr, te = hi_partitions()
    run = lambda trace=None: run_pipeline(
        tr, te, SplitNNConfig(model="knn", n_classes=2), variant="treecss",
        clusters_per_client=14, seed=SEED,
        options=EngineOptions(device=dev, trace=trace),
        align=AlignOptions(protocol="oprf", psi_backend="device"))
    cfg = train_cfg("mlp", 0.01, tr.n_samples, 200)
    mlp = lambda trace=None: drive_split(tr, te, dev, "treecss", cfg, None,
                                         trace)
    rows = []
    for model, fn in (("knn", run), ("mlp", mlp)):
        tracer = fn(trace=True).tracer
        spans = {}
        for sp in tracer.finished():
            spans[sp.name] = spans.get(sp.name, 0.0) + sp.duration * 1e3
        per_name, device_ms, wall_ms = profile_device(fn, reps=1)
        top = sorted(per_name.items(), key=lambda kv: -kv[1])[:10]
        row = {"phase": "profile", "variant": "treecss", "model": model,
               "span_ms": spans, "wall_ms_profiled": wall_ms,
               "device_ms": device_ms,
               "device_busy_share": None if device_ms is None else
               device_ms / wall_ms, "top_device_ops_ms": top}
        emit(row)
        rows.append(row)
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build

    dev = torch.device("cuda")
    smi = nvidia_smi()
    emit({"phase": "device", "nvidia_smi": smi,
          "torch_name": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    secs = build.build_all()
    emit({"phase": "build", "seconds": secs,
          "ptxas": {k: [ln for ln in v.splitlines() if "registers" in ln
                        or "spill" in ln] for k, v in
                    build.PTXAS_REPORT.items()}})
    rows = kernel_phase(dev)
    launches, pipe_rows = pipeline_phase(dev)
    train_runs, train_rows = train_phase(dev)
    rep, mlp_row = train_runs["treecss", "mlp", "kernel"]
    # K1 and K2 count on their own main path, the treecss-mlp job
    launches = launches | {k: mlp_row["launches"][k] for k in
                           ("splitnn_bottom", "splitnn_bottom_gather")}
    pipe_rows += train_rows
    pipe_rows += serve_phase(dev, rep.train.params, train_cfg(
        "mlp", 0.01, 70_000, 200))
    pipe_rows += profile_phase(dev)
    kernels = []
    for r in rows:
        if "check_only" in r:
            continue
        kernels.append({key: r[key] for key in (
            "name", "route", "source", "replaces")} | {
            "launches": launches[r["name"]]} | {key: r[key] for key in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")})
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"),
              "w") as f:
        json.dump({"nvidia_smi": smi, "build_seconds": secs,
                   "kernels": rows, "pipeline": pipe_rows}, f, indent=1)
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
