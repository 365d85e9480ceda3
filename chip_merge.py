"""The merge kernel (K7/K8, ``csrc/sorted_intersect.cu``) on the card, for
a parent-against-change comparison and for its tile geometry.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_merge.py [--src DIR] [--tag NAME] [--instances] [--phases]

``--src`` is the ``src`` directory of the tree to measure (default: this
checkout's).  Another tree, such as a parent commit unpacked with ``git
archive`` into a git-ignored directory, is measured by this same script,
and its kernel is built from its own source into its own ``build/``;
run the two in turns (parent, change, change, parent) in one call.  The
script reaches the port only through ``sorted_intersect_cuda`` and
``ref.sorted_intersect``, which every tree since the align slice has.

At each shape (the HI rounds' one pair at P = 2^17, the YP rounds' at
2^19, one pair at 2^20 and at 2^21, the delta probe's nine pairs at
2^19; ~70% of each side common), on operands made here from a seed, so
both trees see the same keys: the wrapper's outputs bitwise against the
plain version and their SHA-256; device µs a launch (``torch.profiler``,
the mean over 50 launches, 3 sessions); event µs a call (median of 20);
the bound (48 B a P at 3.35 TB/s).  ``--instances`` (this tree) also
times each CTA size the source has, through its launcher, in turns (in
order, then in reverse), each bitwise the wrapper.

``--phases`` (this tree) builds copies of the source into
``build/merge_phases/``, each with a part of the kernel cut (one nvcc
each, all at once), and times each through its own C launcher on the
same operands, at each CTA size, in turns:

- ``full``            the kernel as it is (checked bitwise the wrapper);
- ``no_search``       the tile boundaries' co-ranks taken as d/2, no
                      probes in device memory;
- ``no_merge``        each thread's slots copied from the windows: no
                      shared-memory co-rank, no serial merge;
- ``moves_only``      both cuts: windows loaded, staged and stored;
- ``search_only``     the co-ranks and nothing after them.

The cut copies compute wrong outputs (same bytes moved where they load
and store).

One JSON line a shape, tagged ``--tag``; the last line is nvidia-smi's
name and power limit.  Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
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
#: (pairs, keys a side, common keys a pair); P = the next power of two
SHAPES = ((1, 70_000, 49_000), (1, 357_000, 249_900), (1, 700_000, 490_000),
          (9, 300_000, 210_000), (1, 1_400_000, 980_000))


def emit(tag, obj) -> None:
    print(json.dumps({"tag": tag, **obj}), flush=True)


def operands(pairs, n_side, n_common, dev):
    """(pairs, P) receiver/sender keys, ``n_common`` common a pair,
    padded with the sentinels (-1 receiver, -2 sender)."""
    rng = np.random.default_rng([SEED, pairs, n_side])
    p = 1 << (n_side - 1).bit_length()
    a = np.full((pairs, p), -1, np.int64)
    b = np.full((pairs, p), -2, np.int64)
    for i in range(pairs):
        tags = rng.permutation(np.unique(rng.integers(
            0, 2 ** 62, 3 * n_side, dtype=np.int64)))
        ta = np.sort(np.concatenate([tags[:n_common],
                                     tags[n_common:n_side]]))
        tb = np.sort(np.concatenate([tags[:n_common],
                                     tags[n_side:2 * n_side - n_common]]))
        a[i, :len(ta)] = (ta << 1) | 1
        b[i, :len(tb)] = tb << 1
    return torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)


def launch_us(fn, reps: int = 50, tries: int = 3) -> float:
    """Mean device µs of one merge launch over ``reps`` calls (a profiler
    session that recorded none is run again, up to ``tries``)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total, count = 0.0, 0
        for ev in prof.key_averages():
            if (ev.device_type == torch.autograd.DeviceType.CUDA
                    and "merge" in ev.key):
                t = getattr(ev, "device_time_total", None)
                total += getattr(ev, "cuda_time_total", 0) if t is None else t
                count += ev.count
        if count:
            return total / count
    raise RuntimeError("the profiler recorded no merge launch")


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


CO_RANK = "      const int i = warp_co_rank(a, b, d, p, tid & 31);"
WINDOWS = "    // 2. the windows"
MERGE = "    if (dl < n) {\n      int lo = dl > lb ? dl - lb : 0;"
CUTS = {
    "full": [],
    "no_search": [(CO_RANK, "      const int i = d / 2;")],
    "no_merge": [(MERGE, "    for (int it = 0; it < ITEMS; ++it)\n"
                  "      merged[it] = win[(dl + it) % TILE];\n"
                  "    if (false) {\n      int lo = 0;")],
    "search_only": [(WINDOWS, "    if (tid == 0) rank_all[pair * two_p + d0]"
                     " = i0 + la;\n    continue;\n" + WINDOWS)],
}
CUTS["moves_only"] = CUTS["no_search"] + CUTS["no_merge"]


def phase_libraries():
    """{name: ctypes launcher} of the source's cut copies, built at once."""
    import ctypes
    from repro_torch.kernels import build
    src = (build.CSRC / "sorted_intersect.cu").read_text()
    out_dir = os.path.join(ROOT, "build", "merge_phases")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, subs in CUTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name}: the source no longer holds "
                                   f"{old[:60]!r}")
            text = text.replace(old, new)
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", cu[:-3] + ".so", cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns, ptxas = {}, {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {name}:\n{out}")
        ptxas[name] = [ln.strip() for ln in out.splitlines()
                       if "registers" in ln or "spill stores" in ln]
        fn = ctypes.CDLL(os.path.join(out_dir, name + ".so")
                         ).sorted_intersect_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns, ptxas


def instance(a, b, threads):
    """A call of the wrapper's launcher at the CTA size ``threads`` (one
    of ``kernel.THREADS``) in place of the geometry's, into outputs made
    once (``.outputs``)."""
    from repro_torch.kernels import build
    pairs, p = a.shape
    outputs = (torch.empty((pairs, 2 * p), dtype=torch.int32,
                           device=a.device),
               torch.empty((pairs, 2 * p), dtype=torch.int32,
                           device=a.device),
               torch.empty((pairs, 2 * p), dtype=torch.int64,
                           device=a.device))
    fn = build.function("sorted_intersect", "sorted_intersect_launch", 5, 3)

    def call():
        build.check(build.launch(fn, a.device, a.data_ptr(), b.data_ptr(),
                                 *(t.data_ptr() for t in outputs), pairs, p,
                                 threads), "sorted_intersect")
    call.outputs = outputs
    return call


def phase_times(fns, a, b, threads, want):
    """{variant: [device µs a launch, in turns]} at one CTA size."""
    from repro_torch.kernels import build
    pairs, p = a.shape
    sel = torch.empty((pairs, 2 * p), dtype=torch.int32, device=a.device)
    rank = torch.empty_like(sel)
    merged = torch.empty((pairs, 2 * p), dtype=torch.int64, device=a.device)
    times = {name: [] for name in fns}
    for order in (list(fns), list(fns)[::-1]):
        for name in order:
            call = lambda: build.check(build.launch(
                fns[name], a.device, a.data_ptr(), b.data_ptr(),
                sel.data_ptr(), rank.data_ptr(), merged.data_ptr(), pairs,
                p, threads), name)
            call()
            torch.cuda.synchronize()
            if name == "full" and not all(torch.equal(g, w) for g, w in zip(
                    (sel, rank, merged), want)):
                raise AssertionError(f"the full copy at {threads} threads "
                                     "differs from the wrapper")
            times[name].append(launch_us(call))
    return times


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--tag", default="change")
    ap.add_argument("--instances", action="store_true")
    ap.add_argument("--phases", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_merge: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.kernels import build
    from repro_torch.kernels.sorted_intersect import kernel, ref

    dev = torch.device("cuda")
    build.build_all(["sorted_intersect"])
    emit(args.tag, {"phase": "build", "src": os.path.relpath(
        os.path.abspath(args.src), ROOT), "ptxas": [
            ln for ln in build.PTXAS_REPORT.get("sorted_intersect", "")
            .splitlines() if "registers" in ln or "spill" in ln
            or "entry function" in ln]})
    if args.phases:
        fns, ptxas = phase_libraries()
        emit(args.tag, {"phase": "phase_build", "ptxas": ptxas})
    for pairs, n_side, n_common in SHAPES:
        a, b = operands(pairs, n_side, n_common, dev)
        p = a.shape[1]
        call = lambda: kernel.sorted_intersect_cuda(a, b)
        got, want = call(), ref.sorted_intersect(a, b)
        bitwise = all(torch.equal(g, w) for g, w in zip(got, want))
        if not bitwise or int(got[0].sum()) != pairs * n_common:
            raise AssertionError(f"{pairs} x 2^{p.bit_length() - 1}: the "
                                 "kernel differs from the plain version")
        row = dict(phase="shape", shape=[pairs, p], bitwise=True,
                   sha256=hashlib.sha256(b"".join(
                       t.cpu().numpy().tobytes() for t in got)).hexdigest(),
                   device_us=[launch_us(call) for _ in range(3)],
                   event_us=event_us(call),
                   bound_us=pairs * 48 * p / HBM_BYTES_PER_S * 1e6)
        if args.instances:
            times = {t: [] for t in kernel.THREADS}
            for order in (kernel.THREADS, kernel.THREADS[::-1]):
                for t in order:
                    run = instance(a, b, t)
                    run()
                    if not all(torch.equal(g, w) for g, w in zip(
                            run.outputs, got)):
                        raise AssertionError(f"{t} threads: outputs differ")
                    times[t].append(launch_us(run))
            row["instances_us"] = {str(t): v for t, v in times.items()}
        if args.phases:
            row["phases_us"] = {str(t): phase_times(fns, a, b, t, got)
                                for t in kernel.THREADS}
        emit(args.tag, row)
        del a, b, got, want
        torch.cuda.empty_cache()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
