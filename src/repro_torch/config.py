"""Typed engine configuration: the port of ``repro.config``.

``EngineOptions`` holds the execution-layer knobs and ``AlignOptions``
the alignment-protocol knobs, with the reference's field names and
defaults.  Two differences follow from the platform:

- ``device`` is added: the device of this process (its rank's card, or
  the CPU when a caller asks for it, as the tests do).  ``None`` means
  ``torch.device("cuda")``, the current card, which
  ``launch.mesh.run_ranks`` sets to the rank's own.
- ``mesh``/``shard_axis`` keep the reference's meaning (a 1-D
  ``("data",)`` or 2-D ``("data", "model")`` mesh that shards every
  device stage, ``repro_torch.sharding``), with a
  ``torch.distributed.device_mesh.DeviceMesh`` in place of a JAX mesh:
  every rank of the mesh calls the entry point with the same arguments
  and gets the same result.
- ``AlignOptions.impl`` names the port's kernel implementations,
  ``"kernel"`` (the hand-written CUDA kernels) or ``"ref"`` (their
  plain PyTorch versions).  ``None`` picks by device: ``"kernel"`` on
  CUDA, ``"ref"`` on the CPU.  ``EngineOptions.bottom_impl`` does the
  same for the SplitNN bottom layer and also takes ``"loop"`` (the
  per-client parity oracle); the reference's ``"pallas"`` means
  ``"kernel"``.

The reference's legacy-kwarg shim (``_coerce_options``) is not ported:
the port has no legacy callers, so every entry point takes the option
objects only.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

__all__ = ["EngineOptions", "AlignOptions", "resolve_device", "resolve_impl",
           "resolve_bottom_impl"]


def resolve_device(device: Any = None) -> torch.device:
    """``None`` → the CUDA device; anything else through ``torch.device``.

    Every entry point places its work through here, so this is also
    where f32 is made to mean f32 on the card: for a CUDA device it
    turns TF32 off for both matrix products and cuDNN convolutions
    (PyTorch's default lets cuDNN use TF32, which keeps ~3 digits)."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def resolve_impl(impl: Optional[str], device: torch.device) -> str:
    """The kernel implementation for ``device``: an explicit ``impl`` is
    kept (``"kernel"`` on a CPU device raises where a kernel is reached);
    ``None`` means ``"kernel"`` on CUDA and ``"ref"`` on the CPU."""
    if impl is None:
        return "kernel" if device.type == "cuda" else "ref"
    if impl not in ("kernel", "ref"):
        raise ValueError(f"impl must be 'kernel' or 'ref', got {impl!r}")
    return impl


def resolve_bottom_impl(impl: Optional[str], device: torch.device) -> str:
    """The SplitNN bottom-layer implementation: ``"loop"`` (per-client
    GEMMs, the parity oracle) is kept, ``"pallas"`` means ``"kernel"``,
    and the rest resolves as ``resolve_impl``."""
    if impl == "loop":
        return impl
    return resolve_impl("kernel" if impl == "pallas" else impl, device)


@dataclasses.dataclass(frozen=True)
class EngineOptions:
    """Execution-layer options.  ``device`` places every device stage;
    ``mesh``/``shard_axis`` shard them (the PSI rounds and the coreset
    fit over ``data``, training over ``data`` and, on a 2-D mesh, the
    clients over ``model``: ``repro_torch.sharding``);
    ``trace`` turns on the obs layer (a ``repro_torch.obs.Tracer`` or
    any truthy value).  ``train_engine``/``fuse_gather``/``block_b``/
    ``quant`` keep the reference's names and defaults; ``bottom_impl``
    resolves by device (module docstring).  ``block_b`` is the row count
    of an evaluation batch (the CUDA kernels pick their own tiles);
    ``quant`` ("int8"|"fp8") narrows the activation wire in training,
    evaluation and serving (``repro_torch.quant``).  The k-NN pipeline
    reads none of them."""
    device: Any = None
    mesh: Any = None
    shard_axis: Optional[str] = None
    train_engine: str = "scan"
    bottom_impl: Optional[str] = None
    fuse_gather: bool = True
    block_b: int = 512
    quant: Optional[str] = None
    trace: Any = None


@dataclasses.dataclass(frozen=True)
class AlignOptions:
    """Alignment-protocol options shared by ``tpsi``/``mpsi``/the PSI
    engine/``run_pipeline``.

    ``protocol`` is the TPSI flavor ("rsa"|"oprf"); ``psi_backend``
    "host" (per-element protocol sessions) or "device" (batched
    ``repro_torch.psi.engine`` rounds); ``overlap`` the synthetic common
    id fraction (paper §5.3); ``sort`` the engine's tag-sort mode
    (None = "device" on CUDA, "host" on the CPU); ``impl`` the kernel
    implementation (module docstring); ``device`` the alignment device
    and ``mesh``/``shard_axis`` an alignment mesh (``None`` inherits the
    engine's through ``with_engine_defaults``)."""
    protocol: str = "rsa"
    psi_backend: str = "host"
    overlap: float = 0.7
    sort: Optional[str] = None
    impl: Optional[str] = None
    device: Any = None
    mesh: Any = None
    shard_axis: Optional[str] = None

    def with_engine_defaults(self, engine: EngineOptions) -> "AlignOptions":
        """Inherit the engine device when no alignment device was given,
        and the engine mesh (with its axis unless one was given) when no
        alignment mesh was."""
        out = self
        if out.device is None and engine.device is not None:
            out = dataclasses.replace(out, device=engine.device)
        if out.mesh is None and engine.mesh is not None:
            out = dataclasses.replace(out, mesh=engine.mesh,
                                      shard_axis=out.shard_axis
                                      or engine.shard_axis)
        return out
