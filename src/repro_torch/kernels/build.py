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
first use costs one compile's wall time, not one per source.  A failed
build raises with the compiler's output: nothing falls back to the
plain versions.

``function`` types a launcher once and caches it per (library,
symbol); ``launch`` calls it on the tensors' device with that device's
current stream.

``LAUNCHES`` counts, per kernel, the launches the wrappers made; a
wrapper adds one right where its kernel launched and nowhere else.  A
source may hold more than one kernel, counted apart: ``splitnn_bottom.cu``
holds K1 (``splitnn_bottom``) and K2 (``splitnn_bottom_gather``), which
count their f32 form, with their fp8 wire form, which the fp8 wire runs,
counted apart (``splitnn_bottom_fp8``, ``splitnn_bottom_fp8_gather``),
and their int8 twins K9 (``splitnn_bottom_int8``) and K10
(``splitnn_bottom_int8_gather``), which count the wire form the int8
wire runs; their operands form, on operands quantized outside, counts
apart (``splitnn_bottom_int8_operands``,
``splitnn_bottom_int8_gather_operands``);
``kmeans_update.cu`` K3 (``kmeans_update``) and K4
(``kmeans_update_gather``).  ``sorted_intersect.cu``'s merge counts as
K7 (``sorted_intersect``) up to the reference's single-pass bound and as
K8 (``sorted_intersect_tiled``) past it (``kernels/sorted_intersect``).
The LLM paths' kernels have a source each: ``flash_attention.cu`` holds
K11 (``flash_attention``, every attention layer of a prefill or a
training forward, remat's recompute included), ``flash_attention_bwd.cu``
K11's backward (``flash_attention_bwd``, every attention layer of a
training step's backward: the dq and dk/dv kernels, and in bf16 a third
that sums the dk/dv CTAs' chunks of heads where they split them, counted
once a call) and ``ssd_scan.cu``
K12 (``ssd_scan``, every Mamba2 layer of a prefill).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Any, Dict, List, Tuple

import torch

__all__ = ["SOURCES", "LAUNCHES", "reset_launches", "build_all", "library",
           "function", "stream", "launch", "check", "refuse_grad",
           "require_cuda"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_ext"
SOURCES = {"psi_prf": "psi_prf.cu",
           "sorted_intersect": "sorted_intersect.cu",
           "kmeans_update": "kmeans_update.cu",
           "kmeans_assign": "kmeans_assign.cu",
           "splitnn_bottom": "splitnn_bottom.cu",
           "flash_attention": "flash_attention.cu",
           "flash_attention_bwd": "flash_attention_bwd.cu",
           "ssd_scan": "ssd_scan.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo"]

LAUNCHES: Dict[str, int] = {name: 0 for name in (
    *SOURCES, "splitnn_bottom_gather", "splitnn_bottom_fp8",
    "splitnn_bottom_fp8_gather", "splitnn_bottom_int8",
    "splitnn_bottom_int8_gather", "splitnn_bottom_int8_operands",
    "splitnn_bottom_int8_gather_operands", "kmeans_update_gather",
    "sorted_intersect_tiled")}
_LIBS: Dict[str, ctypes.CDLL] = {}
_FUNCS: Dict[Tuple[str, str], Any] = {}
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


def function(name: str, symbol: str, n_pointers: int, n_ints: int,
             n_floats: int = 0):
    """The C launcher ``symbol`` of kernel ``name``, typed as
    ``(n_pointers × void*, n_ints × long long, n_floats × double, void*
    stream) -> int`` (every launcher in csrc/ has that shape) the first
    time it is asked for, then taken from the cache."""
    fn = _FUNCS.get((name, symbol))
    if fn is None:
        fn = getattr(library(name), symbol)
        fn.argtypes = ([ctypes.c_void_p] * n_pointers
                       + [ctypes.c_longlong] * n_ints
                       + [ctypes.c_double] * n_floats + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FUNCS[name, symbol] = fn
    return fn


def stream(device: torch.device) -> int:
    """The raw handle of ``device``'s current stream (no
    ``torch.cuda.Stream`` object is made)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def launch(fn, device: torch.device, *args) -> int:
    """``fn(*args, stream)`` with ``device``'s current stream, made the
    current device for the call where it is not: the launcher's error
    code.  Every kernel wrapper launches through it, so the device switch
    is paid only where it is needed."""
    if device.index != torch.cuda.current_device():
        with torch.cuda.device(device.index):
            return fn(*args, stream(device))
    return fn(*args, stream(device))


def check(err: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def refuse_grad(name: str, *tensors) -> None:
    """Raise where autograd would need a backward through a kernel that
    has none (K12): the output would silently cut the graph."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the CUDA kernel has no backward, and an "
                           "operand requires grad; training takes the plain "
                           "version (impl='ref')")


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
