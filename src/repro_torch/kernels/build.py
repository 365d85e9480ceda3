"""Build and load the port's CUDA kernels, and count their launches.

Each kernel is one ``.cu`` file under ``kernels/csrc/`` with a plain C
interface (``extern "C"`` launchers that take raw pointers and the
stream).  ``nvcc -shared`` compiles each into its own shared library
under ``build/repro_torch_ext/`` at the repository root (gitignored),
named by the hash of its source, so an edited source is rebuilt and an
unchanged one is reused.  ``ctypes`` loads the library; the wrappers in
``kernels/<name>/kernel.py`` check tensors and pass pointers.

This route needs neither ninja nor PyTorch's headers (which take
minutes to compile); the libraries link against nothing but the CUDA
runtime.  ``build_all`` starts one ``nvcc`` per source at once, so the
first use costs one compile, not four.  A failed build raises with the
compiler's output: nothing falls back to the plain versions.

``LAUNCHES`` counts, per kernel, the launches the wrappers made; a
wrapper adds one right where its kernel launched and nowhere else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List

__all__ = ["SOURCES", "LAUNCHES", "reset_launches", "build_all", "library",
           "function", "check", "require_cuda"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_ext"
SOURCES = {"psi_prf": "psi_prf.cu",
           "sorted_intersect": "sorted_intersect.cu",
           "kmeans_update": "kmeans_update.cu",
           "kmeans_assign": "kmeans_assign.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo"]

LAUNCHES: Dict[str, int] = {name: 0 for name in SOURCES}
_LIBS: Dict[str, ctypes.CDLL] = {}
#: per kernel, the ``-Xptxas -v`` report of its last build (registers,
#: shared memory, spills) — printed by chip_smoke.py
PTXAS_REPORT: Dict[str, str] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        nvcc = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return nvcc


def _target(name: str) -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / SOURCES[name], *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.read_bytes())
    digest = h.hexdigest()
    return BUILD_DIR / f"{name}-{digest[:12]}.so"


def build_all(names: List[str] | None = None) -> float:
    """Compile every kernel library that is missing, one ``nvcc`` per
    source, all started together.  Returns the wall seconds spent;
    raises ``RuntimeError`` with the compiler output if any fails."""
    names = list(SOURCES) if names is None else names
    todo = [n for n in names if not _target(n).exists()]
    t0 = time.perf_counter()
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = _target(n).with_suffix(f".{os.getpid()}.tmp")
        procs[n] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[n])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    errors = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        PTXAS_REPORT[n] = out
        if proc.returncode != 0:
            errors.append(f"--- nvcc {SOURCES[n]} (rc={proc.returncode})\n"
                          f"{out}")
        else:
            os.replace(tmp, _target(n))
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = _LIBS[name] = ctypes.CDLL(str(_target(name)))
    return lib


def function(name: str, symbol: str, n_pointers: int, n_ints: int):
    """The C launcher ``symbol`` of kernel ``name``, typed as
    ``(n_pointers × void*, n_ints × long long, void* stream) -> int``
    (every launcher in csrc/ has that shape)."""
    fn = getattr(library(name), symbol)
    fn.argtypes = ([ctypes.c_void_p] * n_pointers
                   + [ctypes.c_longlong] * n_ints + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def check(err: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def require_cuda(name: str, *tensors, dtype=None) -> None:
    """Validate a kernel's operands before their pointers are passed:
    CUDA, one device, contiguous, and of ``dtype`` where given."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: the CUDA kernel needs CUDA tensors, "
                             f"got one on {t.device}; use impl='ref' on the "
                             "CPU")
        if t.device != dev:
            raise ValueError(f"{name}: operands on {dev} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
        if dtype is not None and t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
