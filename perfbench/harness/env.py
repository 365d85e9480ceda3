"""The run's environment, fixed before numpy and torch load: host
thread counts, the build and kernel caches inside the checkout, the
program's source on ``sys.path``; and the process's start time, from
which ``setup_s`` counts."""
from __future__ import annotations

import os
import sys
import time
from pathlib import Path

#: threads the run gives OpenMP, the BLAS libraries and torch: the
#: program's host work is one Python thread, and on a host shared with
#: others one thread of ours contends least
THREADS = 1
#: top-level module names that may not be loaded when a run ends: JAX
#: and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_start() -> float:
    """Wall-clock time (``time.time()``) at which this process started,
    from ``/proc`` (10 ms resolution); ``time.time()`` now where that
    cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def prepare(root: Path) -> dict:
    """Set the environment of a run in checkout ``root``; returns what
    was set, for the run's record."""
    fixed = {name: str(THREADS) for name in (
        "OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS",
        "NUMEXPR_NUM_THREADS")}
    build = root / "build"
    fixed.update({"TORCH_EXTENSIONS_DIR": str(build / "torch_extensions"),
                  "TRITON_CACHE_DIR": str(build / "triton"),
                  "CUDA_CACHE_PATH": str(build / "cuda_cache"),
                  "USE_FLAX": "0"})
    os.environ.update(fixed)
    src = str(root / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    return fixed


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is one of
    ``FORBIDDEN``."""
    return sorted(name for name in list(sys.modules)
                  if name.split(".")[0] in FORBIDDEN)
