"""Where the device time of the fused k-means step (K3, K4) goes.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_kmeans_phases.py

It builds copies of ``src/repro_torch/kernels/csrc/kmeans_update.cu``
into ``build/kmeans_phases/``, each with one phase of the kernel cut,
all with the width instances d = 11 and 30 only (one nvcc each, all at
once), and times each copy through the unchanged wrappers on the same
seeded inputs: K3 at the HI coreset fit (3, 49,000, 11, K = 14), K3 at
the YP fit (3, 249,900, 30, K = 12) and K4 at a YP minibatch step
(1,024 indices into (1, 357,000, 30), K = 12).  Device µs a call
(``torch.profiler``, mean of 30 calls), three rounds with the copies in
turn, one JSON line a copy:

- ``full``           the kernel as it is;
- ``no_reduce``      returns before the reduce across CTAs;
- ``no_sums``        no sort by cluster and no per-cluster sums;
- ``no_dist``        no distances (each row takes cluster t mod K);
- ``loads_only``     none of the three: staging, the writes of assign
                     and sqd, and the barriers.

The cut copies compute wrong sums; only ``full`` is checked (against
the build the wrappers load, bit for bit).  The last line is
nvidia-smi's name and power limit.  Exits non-zero without a card.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

SORT = "    // stable counting sort"
REDUCE = "  // publish the partial"
NEAREST = "kmeans::nearest(p + t * d, c_s, c2_s, k, k_real, d, &q, &dist);"
TABLE = ("      kernel_table<GATHER>(std::make_integer_sequence<int, "
         "D_FIXED + 1>{});\n  const auto kernel = table[d <= D_FIXED ? d "
         ": 0];")


def _sub(src: str, old: str, new: str) -> str:
    if old not in src:
        raise RuntimeError(f"kmeans_update.cu no longer holds {old[:50]!r}")
    return src.replace(old, new)


def variants(src: str):
    """The kernel source as it is and with each cut, keyed by name."""
    src = _sub(src, TABLE, (
        "      kernel_table<GATHER>(std::integer_sequence<int, 0, 11, 30>{});"
        "\n  const auto kernel = table[d == 11 ? 1 : d == 30 ? 2 : 0];"))
    _sub(src, SORT, SORT)             # the markers the cuts need
    _sub(src, REDUCE, REDUCE)
    no_reduce = lambda s: _sub(s, REDUCE, "  return;\n" + REDUCE)
    no_sums = lambda s: s[:s.index(SORT)] + "  }\n\n" + s[s.index(REDUCE):]
    no_dist = lambda s: _sub(s, NEAREST, "{ q = t % k; dist = p[t * d]; }")
    return {"full": src, "no_reduce": no_reduce(src),
            "no_sums": no_sums(src), "no_dist": no_dist(src),
            "loads_only": no_reduce(no_sums(no_dist(src)))}


def build_variants(out_dir: str):
    from repro_torch.kernels import build
    src = open(build.CSRC / build.SOURCES["kmeans_update"]).read()
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, text in variants(src).items():
        cu = os.path.join(out_dir, name + ".cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
             cu[:-3] + ".so", cu], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {name}.cu failed:\n{out}")
        libs[name] = ctypes.CDLL(os.path.join(out_dir, name + ".so"))
    return libs


def device_us(fn, reps: int = 30) -> float:
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(ev.device_time_total for ev in prof.key_averages()
               if "kmeans_update_kernel" in ev.key) / reps


def clustered(rng, m, n, d, k, dev):
    """(m, n, d) f32 points around k seeded centres, and k of them as
    centroids."""
    centre = rng.normal(0, 4, (m, k, d))
    label = rng.integers(0, k, (m, n))
    x = np.take_along_axis(centre, label[..., None], 1) + rng.normal(
        0, 1, (m, n, d))
    pts = torch.from_numpy(x.astype(np.float32)).to(dev)
    return pts, pts[:, :k].contiguous()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_kmeans_phases: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.kernels.kmeans_update import kernel as ku

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    hi, c_hi = clustered(rng, 3, 49_000, 11, 14, dev)
    yp, c_yp = clustered(rng, 3, 249_900, 30, 12, dev)
    mb, c_mb = clustered(rng, 1, 357_000, 30, 12, dev)
    idx = torch.from_numpy(rng.integers(0, 357_000, (1, 1024)).astype(
        np.int32)).to(dev)
    cases = {"K3 HI": lambda: ku.kmeans_update_cuda(hi, c_hi),
             "K3 YP": lambda: ku.kmeans_update_cuda(yp, c_yp),
             "K4 YP": lambda: ku.kmeans_update_gather_cuda(mb, c_mb, idx)}
    want = {case: fn() for case, fn in cases.items()}
    libs = build_variants(os.path.join(ROOT, "build", "kmeans_phases"))
    build._LIBS["kmeans_update"] = libs["full"]
    for case, fn in cases.items():
        got = fn()
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want[case])):
            raise AssertionError(f"{case}: the full copy differs from the "
                                 "wrappers' build")
    times = {name: {case: [] for case in cases} for name in libs}
    for _ in range(3):
        for name, lib in libs.items():
            build._LIBS["kmeans_update"] = lib
            for case, fn in cases.items():
                times[name][case].append(device_us(fn))
    for name, row in times.items():
        print(json.dumps({"variant": name, "device_us": row}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
