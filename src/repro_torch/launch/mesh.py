"""Meshes over the running process group, and a rank launcher: the port
of ``repro.launch.mesh``.

The reference builds JAX meshes over the devices one process sees; the
port runs one process a rank (``repro_torch.sharding``), so a mesh here
is a ``DeviceMesh`` over the ranks of the default process group, with
the reference's dim names.  Every rank builds the same meshes in the
same order (building one makes process groups, a collective step).

``run_ranks`` starts a world of ranks for a caller that is not itself
one (the tests, ``chip_smoke.py``): ``world`` processes (spawned, so no
CUDA state or thread is inherited) join one process group through a
``file://`` store in a fresh directory, each sets its device and calls
``fn(device, *args)``; the parent joins them with a timeout and returns
each rank's return value.  A rank that raises, dies or outlives the
timeout fails the call, and every rank still alive is then stopped.

``make_production_mesh`` gives the reference's production meshes, one
pod (16, 16) ``("data", "model")`` or two (2, 16, 16) ``("pod", "data",
"model")``: a ``DeviceMesh`` inside a world of that many ranks, else
their shape alone, which ``launch/specs`` and ``launch/dryrun`` lay
params, batches and caches out on.
"""
from __future__ import annotations

import math
import os
import pickle
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

__all__ = ["make_production_mesh", "make_data_mesh", "make_train_mesh",
           "make_pod_mesh", "make_host_mesh", "default_backend", "run_ranks"]


def _mesh(shape, names):
    from torch.distributed.device_mesh import DeviceMesh
    n = 1
    for s in shape:
        n *= s
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False):
    """The production mesh: (16, 16) ``("data", "model")``, or with
    ``multi_pod`` (2, 16, 16) ``("pod", "data", "model")``.  A
    ``DeviceMesh`` over the ranks where a process group of that size is
    running; otherwise its shape (``sharding.MeshShape``), what the
    layout rules read."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    if dist.is_initialized() and dist.get_world_size() == math.prod(shape):
        return _mesh(shape, names)
    from repro_torch.sharding import MeshShape
    return MeshShape(names, shape)


def make_data_mesh(n_devices: Optional[int] = None, *, model: int = 1):
    """``("data",)`` mesh over the first ``n_devices`` ranks of the
    running process group (all of them by default), the mesh of the
    PSI/CSS batch-sharding paths.  ``model > 1`` folds the ranks into a
    ``(n_devices / model, model)`` grid named ``("data", "model")``, the
    2-D train mesh: ``data`` keeps the batch, ``model`` takes the
    clients of the SplitNN bottom."""
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n > world:
        raise ValueError(f"requested {n} devices, have {world}")
    if model > 1:
        if n % model:
            raise ValueError(f"{n} devices do not fold into a (data, "
                             f"model={model}) grid")
        return _mesh((n // model, model), ("data", "model"))
    return _mesh((n,), ("data",))


def make_train_mesh(data: int, model: int):
    """The 2-D ``(data, model)`` train mesh over the first
    ``data * model`` ranks: ``make_data_mesh(data * model,
    model=model)``."""
    return make_data_mesh(data * model, model=model)


def make_pod_mesh(pod: int, data: int, model: int):
    """A ``(pod, data, model)`` train mesh over the first ``pod * data *
    model`` ranks, named as the reference's multi-pod production mesh:
    batch rows over ``pod`` and ``data``, params replicated over
    ``pod`` (``sharding.LMLayout``)."""
    n = pod * data * model
    if n > dist.get_world_size():
        raise ValueError(f"requested {n} devices, have "
                         f"{dist.get_world_size()}")
    return _mesh((pod, data, model), ("pod", "data", "model"))


def make_host_mesh():
    """A (1, 1) ``("data", "model")`` mesh over rank 0: every sharded
    path collapses on it to the single-device one.  A process that is
    not a rank of a world gets its shape alone
    (``sharding.MeshShape``), which the paths read the same way."""
    if not dist.is_initialized():
        from repro_torch.sharding import MeshShape
        return MeshShape(("data", "model"), (1, 1))
    return _mesh((1, 1), ("data", "model"))


def default_backend(world: int, device: Any = None) -> str:
    """NCCL where every rank can have a card of its own, else gloo (the
    CPU, or several ranks on one card, whose CUDA tensors the
    collectives stage through host memory)."""
    if device is not None and torch.device(device).type == "cpu":
        return "gloo"
    if torch.cuda.is_available() and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def _rank_device(rank: int, device: Any) -> torch.device:
    if device is not None:
        return torch.device(device)
    if torch.cuda.is_available():
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device("cpu")


def _rank_main(rank: int, world: int, backend: str, device: Any,
               out_dir: str) -> None:
    with open(os.path.join(out_dir, "call.pkl"), "rb") as f:
        fn, args = pickle.load(f)
    store = os.path.join(out_dir, "store")
    dev = _rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{store}",
                            world_size=world, rank=rank)
    try:
        result = fn(dev, *args)
        dist.barrier()
    except BaseException:
        # the first rank to fail is the cause; the others fail after it
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(f"{time.time()!r}\n{traceback.format_exc()}")
        raise
    finally:
        dist.destroy_process_group()
    tmp = os.path.join(out_dir, f"rank{rank}.tmp")
    with open(tmp, "wb") as f:
        pickle.dump(result, f)
    os.replace(tmp, os.path.join(out_dir, f"rank{rank}.pkl"))


def _first_failure(out_dir: str, world: int) -> str:
    """The traceback of the rank that failed first."""
    failures = []
    for rank in range(world):
        path = os.path.join(out_dir, f"rank{rank}.err")
        if os.path.exists(path):
            with open(path) as f:
                when, tb = f.read().split("\n", 1)
            failures.append((float(when), rank, tb))
    if not failures:
        return "a rank died without a traceback"
    _, rank, tb = min(failures)
    return f"rank {rank} of {world} failed first:\n{tb}"


def run_ranks(fn: Callable, world: int, args: Sequence = (), *,
              device: Any = None, backend: Optional[str] = None,
              timeout: float = 120.0, workdir: Optional[str] = None
              ) -> List[Any]:
    """Run ``fn(device, *args)`` on ``world`` ranks of one process group
    and return their results, rank 0 first.

    ``fn`` must be importable by name (the ranks are spawned); ``args``
    and the results are pickled.  ``backend`` defaults to
    ``default_backend(world, device)``; ``device`` names every rank's
    device, ``None`` meaning card ``rank % cards`` where there are cards
    and the CPU elsewhere.  The store and the results live in a fresh
    directory under ``workdir`` (the temp dir by default), removed
    afterwards; so do ``fn`` and ``args``, which the ranks read from a
    file (a spawned process reads its arguments from a pipe only once
    it has started, and a pipe holds 64 KB: larger arguments would
    start the ranks one after another).  Raises if a rank fails or the
    world has not finished within ``timeout`` seconds, after stopping
    every rank."""
    backend = backend or default_backend(world, device)
    tmp = tempfile.mkdtemp(prefix="ranks-", dir=workdir)
    try:
        with open(os.path.join(tmp, "call.pkl"), "wb") as f:
            pickle.dump((fn, tuple(args)), f)
        ctx = torch.multiprocessing.start_processes(
            _rank_main, args=(world, backend, device, tmp), nprocs=world,
            join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while True:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"{world} ranks of {fn.__name__} did "
                                       f"not finish within {timeout} s")
                try:
                    if ctx.join(timeout=left):
                        break
                except Exception as e:
                    raise RuntimeError(_first_failure(tmp, world)) from e
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                    p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join(10)
        results = []
        for rank in range(world):
            with open(os.path.join(tmp, f"rank{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
