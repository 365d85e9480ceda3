"""The k-means assign kernel (K5, ``csrc/kmeans_assign.cu``) on the card,
for a parent-against-change comparison and for what binds it.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_assign.py [--src DIR] [--tag NAME] [--variants]

``--src`` is the ``src`` directory of the tree to measure (default: this
checkout's).  Another tree, such as a parent commit unpacked with ``git
archive`` into a git-ignored directory, is measured by this same script,
and its kernels are built from its own sources into its own ``build/``;
run the two in turns (parent, change, change, parent) in one call.  The
script reaches the port only through ``kmeans_assign_cuda`` and
``kmeans_update_cuda``, which every tree since the k-NN slice has.

At each shape (the HI coreset fit (3, 49,000, 11), K = 14; the YP fit
(3, 249,900, 30), K = 12; a YP minibatch build's end (1, 357,000, 30),
K = 12), on clustered points made here from a seed (so both trees see the
same operands) and K of them as centroids: the SHA-256 of K5's assign and
sqd and of K3's four outputs on the same operands (equal lines mean equal
bits across trees); whether K3's assign and sqd equal K5's; device µs a
launch (``torch.profiler``, the mean over 50 launches, 3 sessions), warm
(the launches back to back, so operands that fit the 50 MB L2 are served
from it) and cold (a 256 MB read before each launch evicts them, as on
the main path, where other kernels run between two assignments); event
µs a call (median of 20, warm); the bound (the points read once, 8 B a
row written, at 3.35 TB/s).

``--variants`` (this tree) builds copies of the source into
``build/assign_variants/`` with the widths 11 and 30 only and R = 1, 2, 4
rows a thread at each (one nvcc each, all at once), and times each, cold,
through its own C launcher at every R, in turns (in order, then in
reverse):

- ``bulk``          the shipped staging: a tile's body by one bulk copy
                    under an mbarrier, one buffer;
- ``bulk_2``, ``bulk_3``  a ring of 2 and 3 buffers, each refilled with
                    the tile 2 or 3 ahead (``RING``, in place of the
                    shipped kernel's body);
- ``cp_async``      the ring's code at 1 buffer, the body by 16-byte
                    cp.async;
- ``cp_async_2``    the same with 2 buffers;
- ``unroll_1``      the shipped kernel with its centroid loop not unrolled
                    (the shipped one: by 2);
- ``no_dist``       the shipped staging, the rows' loads into registers
                    and their norms, and the writes: no distance (sqd =
                    ‖p‖²);
- ``moves_only``    the shipped staging and the writes only;
- ``compute_only``  no copy of the rows (the distances of whatever the
                    buffer holds) and the writes.

The full copies are checked bitwise against the wrapper; the cut copies
compute wrong outputs.  One JSON line a shape, tagged ``--tag``; the last
line is nvidia-smi's name and power limit.  Exits non-zero without a
card.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 peak bandwidth
#: (M, N, d, K)
SHAPES = ((3, 49_000, 11, 14), (3, 249_900, 30, 12), (1, 357_000, 30, 12))
MARK = "assign_kernel"

FLUSH_BYTES = 256 << 20          # read before a cold launch: 5× the L2
CTAS_PER_SM = {1: 8, 2: 4, 4: 3}  # min_ctas of each R in the variants

# What every variant copy changes: widths 11 and 30 only, R = 1, 2, 4 at
# each, and the register cap of R = 2
WIDTH_PICK = """\
  using Widths = std::make_integer_sequence<int, D_FIXED + 1>;
  static const auto table = kernel_table(Widths{});
  const int w = d <= D_FIXED ? (int)d : 0;
  const auto kernel = r == rows_per_thread(w) ? table[w] : nullptr;
"""
VARIANT_PICK = """\
#define PICK(D) (r == 1 ? &assign_kernel<D, 1> : r == 2 ? &assign_kernel<D, 2> \\
                 : r == 4 ? &assign_kernel<D, 4> : nullptr)
  const auto kernel = d == 11 ? PICK(11) : d == 30 ? PICK(30) : nullptr;
"""
MIN_CTAS = "return r == 1 ? 8 : 3;"
VARIANT_MIN_CTAS = "return r == 1 ? 8 : r == 2 ? 4 : 3;"

# The ring: STAGES tile buffers, each under its own mbarrier, refilled
# with the tile STAGES ahead; BULK = false moves a tile's body by 16-byte
# cp.async.  It takes the place of the shipped kernel's body from BODY on.
CONSTS = "constexpr int SMEM_MAX = 232448; // bytes of shared memory a CTA may use\n"
SMEM = """\
  return 4 * ((size_t)tile_floats(tile, d) + (size_t)k * round4(d) +
              round4(k)) + 8;"""
RING_SMEM = """\
  return 4 * ((size_t)STAGES * tile_floats(tile, d) + (size_t)k * round4(d) +
              round4(k)) + 8 * STAGES;"""
HELPERS = "// until this thread's cp.async copies have landed\n"
RING_HELPERS = """\
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\\n" ::"r"(
                   smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\\n" ::"n"(N) : "memory");
}

"""
BODY = "  float* c_s = smem + tf;     // the tile buffer, then the centroids\n"
BODY_END = "\n// assign_kernel<D, rows_per_thread(D)> for each width D in Ds\n"
RING = """\
  float* c_s = smem + STAGES * tf;
  float* c2_s = c_s + k * dp;
  uint64_t* bar_s = reinterpret_cast<uint64_t*>(c2_s + round4(k));
  const int m = blockIdx.y, t = threadIdx.x;
  const int64_t row0 = (int64_t)m * n + (int64_t)blockIdx.x * rows_per_cta;
  const int rows = (int)min((int64_t)rows_per_cta,
                            n - (int64_t)blockIdx.x * rows_per_cta);
  const int n_tiles = (rows + tile - 1) / tile;
  const float* pts = points + row0 * d;
  const int off = (int)((reinterpret_cast<uintptr_t>(pts) >> 2) & 3);
  auto rows_of = [&](int i) { return min(tile, rows - i * tile); };
  auto stage = [&](int i, int s) {
    const float* g = pts + (int64_t)i * tile * d;
    float* dst = smem + s * tf + off;
    const int cnt = rows_of(i) * d;
    const int head = min(cnt, (4 - off) & 3);
    const int n16 = (cnt - head) / 4;
    const int tail = head + 4 * n16;
    if (t < head) cp_async4(dst + t, g + t);
    if (t < cnt - tail) cp_async4(dst + tail + t, g + tail + t);
    if (BULK) {
      if (t == 0) {
        asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
        mbar_expect_tx(bar_s + s, 16u * n16);
        if (n16 > 0) bulk_copy(dst + head, g + head, 16u * n16, bar_s + s);
      }
    } else {
      for (int c = t; c < n16; c += THREADS)
        cp_async16(dst + head + 4 * c, g + head + 4 * c);
    }
  };
  if (BULK && t == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(bar_s + s);
    asm volatile("fence.mbarrier_init.release.cluster;\\n" ::: "memory");
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < STAGES; ++i) {
    if (i < n_tiles) stage(i, i);
    cp_async_commit();
  }
  const float* c = cents + (int64_t)m * k * d;
  for (int e = t; e < k * dp; e += THREADS) {
    const int q = e / dp, j = e - q * dp;
    c_s[e] = j < d ? c[q * d + j] : 0.f;
  }
  __syncthreads();
  for (int q = t; q < k; q += THREADS) {
    float s = 0.f;
    for (int j = 0; j < d; ++j) s = fmaf(c_s[q * dp + j], c_s[q * dp + j], s);
    c2_s[q] = s;
  }
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % STAGES;
    cp_async_wait<STAGES - 1>();
    if (BULK) mbar_wait(bar_s + s, (i / STAGES) & 1);
    __syncthreads();
    const int64_t r0 = row0 + (int64_t)i * tile;
    assign_rows<D, R>(smem + s * tf + off, rows_of(i), c_s, c2_s, k, k_real,
                      d, assign + r0, sqd + r0, [&] {
                        __syncthreads();
                        if (i + STAGES < n_tiles) stage(i + STAGES, s);
                        cp_async_commit();
                      });
  }
}
"""
CENTROIDS = ("#pragma unroll 2\n    for (int q = 0; q < k; ++q) {\n"
             "      const float4* cq")
NORM_OUT = "      best[r] = INFINITY;"
CUT_LOOP = ("    for (int q = 0; q < 0; ++q) {\n"
            "      const float4* cq")
TILE_FLOATS = "    const int cnt = rows_of(i) * d;"


def ring(stages: int, bulk: bool):
    """The edits that put a ring of ``stages`` buffers in place of the
    shipped kernel's body (the 16-byte cp.async route unless ``bulk``)."""
    return [(CONSTS, CONSTS + f"constexpr int STAGES = {stages};\n"
             f"constexpr bool BULK = {str(bulk).lower()};\n"),
            (SMEM, RING_SMEM), (HELPERS, RING_HELPERS + HELPERS),
            (BODY, RING)]


VARIANTS = {
    "bulk": [],
    "bulk_2": ring(2, True),
    "bulk_3": ring(3, True),
    "cp_async": ring(1, False),
    "cp_async_2": ring(2, False),
    "unroll_1": [(CENTROIDS, CENTROIDS.replace("unroll 2", "unroll 1"))],
    "no_dist": [(CENTROIDS, CUT_LOOP), (NORM_OUT, "      best[r] = p2[r];")],
    "moves_only": [(CENTROIDS, CUT_LOOP)],
    "compute_only": [(TILE_FLOATS, "    const int cnt = 0 * rows_of(i) * d;")],
}
#: the variants that compute wrong outputs
CUTS = ("no_dist", "moves_only", "compute_only")
#: buffers in each variant's ring
VARIANT_STAGES = {"bulk_2": 2, "bulk_3": 3, "cp_async_2": 2}


def emit(tag, obj) -> None:
    print(json.dumps({"tag": tag, **obj}), flush=True)


def operands(m, n, d, k, dev):
    """(m, n, d) f32 points around k seeded centres per client, and the
    first k rows of each client as its centroids."""
    rng = np.random.default_rng([SEED, m, n, d, k])
    centre = rng.normal(0, 4, (m, k, d))
    label = rng.integers(0, k, (m, n))
    x = np.take_along_axis(centre, label[..., None], 1) + rng.normal(
        0, 1, (m, n, d))
    pts = torch.from_numpy(x.astype(np.float32)).to(dev)
    return pts, pts[:, :k].contiguous()


def sha256(tensors) -> str:
    return hashlib.sha256(b"".join(
        t.contiguous().cpu().numpy().tobytes() for t in tensors)).hexdigest()


def launch_us(fn, flush=None, reps: int = 50, tries: int = 3) -> float:
    """Mean device µs of one K5 launch over ``reps`` calls, each after
    ``flush()`` if given (a profiler session that recorded none is run
    again, up to ``tries``)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if flush is not None:
                    flush()
                fn()
            torch.cuda.synchronize()
        total, count = 0.0, 0
        for ev in prof.key_averages():
            if (ev.device_type == torch.autograd.DeviceType.CUDA
                    and MARK in ev.key):
                t = getattr(ev, "device_time_total", None)
                total += getattr(ev, "cuda_time_total", 0) if t is None else t
                count += ev.count
        if count:
            return total / count
    raise RuntimeError("the profiler recorded no assign launch")


def l2_flush(dev):
    """A call that reads ``FLUSH_BYTES`` from the card's memory, leaving
    the L2 full of other, clean lines."""
    buf = torch.ones(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    return lambda: buf.sum()


def event_us(fn, reps: int = 20) -> float:
    for _ in range(3):
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
        times.append(start.elapsed_time(end) * 1e3)
    return float(np.median(times))


def variant_libraries():
    """({name: ctypes launcher}, {name: ptxas lines}) of the source's
    variant copies, built at once."""
    from repro_torch.kernels import build
    src = (build.CSRC / build.SOURCES["kmeans_assign"]).read_text()
    subs = [(WIDTH_PICK, VARIANT_PICK), (MIN_CTAS, VARIANT_MIN_CTAS)]
    out_dir = os.path.join(ROOT, "build", "assign_variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, cuts in VARIANTS.items():
        text = src
        for old, new in subs + cuts:
            if old not in text:
                raise RuntimeError(f"{name}: the source no longer holds "
                                   f"{old[:60]!r}")
            if new is RING:           # the kernel's body, to its end
                a = text.index(old)
                text = text[:a] + RING + text[text.index(BODY_END, a):]
            else:
                text = text.replace(old, new)
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
             cu[:-3] + ".so", cu], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    fns, ptxas = {}, {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {name}:\n{out}")
        ptxas[name] = [ln.strip() for ln in out.splitlines()
                       if "registers" in ln or "spill stores" in ln]
        fn = ctypes.CDLL(os.path.join(out_dir, name + ".so")
                         ).kmeans_assign_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 9 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns, ptxas


def variant_geometry(m, n, k, d, r, stages):
    """kernel.geometry's cut for R = ``r`` rows a thread and a ring of
    ``stages`` buffers: (r, tile, rows_per_cta, ctas), tiles of THREADS·R
    rows (they fit shared memory at every shape here)."""
    from repro_torch.kernels.kmeans_assign import kernel
    tile = kernel.THREADS * r
    smem = kernel.smem_bytes(tile, k, d) + (stages - 1) * (
        4 * ((tile * d + 6) & ~3) + 8)
    assert smem <= kernel.SMEM_MAX, (m, n, k, d, r, stages)
    per_sm = max(1, min(CTAS_PER_SM[r], kernel.SMEM_SM // (smem + 1024)))
    cap = max(1, kernel.SMS * per_sm // m)
    rows_per_cta = 32 * max(1, -(-n // (32 * cap)))
    return r, tile, rows_per_cta, -(-n // rows_per_cta)


def variant_times(fns, pts, cents, want, flush):
    """{variant: {R: [cold device µs a launch, in turns]}} at one shape;
    each full variant's outputs must equal ``want`` bit for bit."""
    from repro_torch.kernels import build
    m, n, d = pts.shape
    k = cents.shape[1]
    assign = torch.empty((m, n), dtype=torch.int32, device=pts.device)
    sqd = torch.empty((m, n), dtype=torch.float32, device=pts.device)
    times = {name: {r: [] for r in (1, 2, 4)} for name in fns}
    runs = [(name, r) for name in fns for r in (1, 2, 4)]
    for order in (runs, runs[::-1]):
        for name, r in order:
            geo = variant_geometry(m, n, k, d, r, VARIANT_STAGES.get(name, 1))
            call = lambda: build.check(build.launch(
                fns[name], pts.device, pts.data_ptr(), cents.data_ptr(),
                assign.data_ptr(), sqd.data_ptr(), m, n, k, k, d, *geo),
                name)
            call()
            torch.cuda.synchronize()
            if name not in CUTS and not (
                    torch.equal(assign, want[0])
                    and torch.equal(sqd.view(torch.int32),
                                    want[1].view(torch.int32))):
                raise AssertionError(f"{name} at R = {r} differs from the "
                                     "wrapper")
            times[name][r].append(launch_us(call, flush))
    return {name: {str(r): v for r, v in row.items()}
            for name, row in times.items()}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--tag", default="change")
    ap.add_argument("--variants", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_assign: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.kernels import build
    from repro_torch.kernels.kmeans_assign.kernel import kmeans_assign_cuda
    from repro_torch.kernels.kmeans_update.kernel import kmeans_update_cuda

    dev = torch.device("cuda")
    build.build_all(["kmeans_assign", "kmeans_update"])
    emit(args.tag, {"phase": "build", "src": os.path.relpath(
        os.path.abspath(args.src), ROOT), "ptxas": [
            ln for ln in build.PTXAS_REPORT.get("kmeans_assign", "")
            .splitlines() if "registers" in ln or "spill" in ln
            or "entry function" in ln]})
    if args.variants:
        fns, ptxas = variant_libraries()
        emit(args.tag, {"phase": "variant_build", "ptxas": ptxas})
    flush = l2_flush(dev)
    for m, n, d, k in SHAPES:
        pts, cents = operands(m, n, d, k, dev)
        call = lambda: kmeans_assign_cuda(pts, cents)
        got = call()
        k3 = kmeans_update_cuda(pts, cents)
        torch.cuda.synchronize()
        row = dict(phase="shape", shape=[m, n, d, k],
                   sha256=sha256(got), k3_sha256=sha256(k3),
                   k3_equals_k5=bool(torch.equal(got[0], k3[0]) and torch.equal(
                       got[1].view(torch.int32), k3[1].view(torch.int32))),
                   device_us=[launch_us(call) for _ in range(3)],
                   cold_device_us=[launch_us(call, flush) for _ in range(3)],
                   event_us=event_us(call),
                   bound_us=(m * n * d * 4 + m * k * d * 4 + m * n * 8)
                   / HBM_BYTES_PER_S * 1e6)
        if not row["k3_equals_k5"]:
            raise AssertionError(f"{m, n, d, k}: K3's assign/sqd differ "
                                 "from K5's")
        if args.variants:
            row["variants_cold_us"] = variant_times(fns, pts, cents, got,
                                                    flush)
        emit(args.tag, row)
        del pts, cents, got, k3
        torch.cuda.empty_cache()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
