"""Typed engine configuration: the port of ``repro.config``.

``EngineOptions`` holds the execution-layer knobs and ``AlignOptions``
the alignment-protocol knobs, with the reference's field names and
defaults.  Two differences follow from the platform:

- ``mesh`` becomes ``device``: the port runs on one CUDA device (or on
  the CPU when a caller asks for it, as the tests do).  ``None`` means
  ``torch.device("cuda")``.  There is no mesh, so ``shard_axis`` is
  gone.
- ``AlignOptions.impl`` names the port's kernel implementations,
  ``"kernel"`` (the hand-written CUDA kernels) or ``"ref"`` (their
  plain PyTorch versions).  ``None`` picks by device: ``"kernel"`` on
  CUDA, ``"ref"`` on the CPU.

The reference's legacy-kwarg shim (``_coerce_options``) is not ported:
the port has no legacy callers, so every entry point takes the option
objects only.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

__all__ = ["EngineOptions", "AlignOptions", "resolve_device", "resolve_impl"]


def resolve_device(device: Any = None) -> torch.device:
    """``None`` → the CUDA device; anything else through ``torch.device``."""
    return torch.device("cuda") if device is None else torch.device(device)


def resolve_impl(impl: Optional[str], device: torch.device) -> str:
    """The kernel implementation for ``device``: an explicit ``impl`` is
    kept (``"kernel"`` on a CPU device raises where a kernel is reached);
    ``None`` means ``"kernel"`` on CUDA and ``"ref"`` on the CPU."""
    if impl is None:
        return "kernel" if device.type == "cuda" else "ref"
    if impl not in ("kernel", "ref"):
        raise ValueError(f"impl must be 'kernel' or 'ref', got {impl!r}")
    return impl


@dataclasses.dataclass(frozen=True)
class EngineOptions:
    """Execution-layer options.  ``device`` places every device stage;
    ``trace`` turns on the obs layer (a ``repro_torch.obs.Tracer`` or
    any truthy value).  ``train_engine``/``bottom_impl``/
    ``fuse_gather``/``block_b``/``quant`` keep the reference's names and
    defaults for the SplitNN training slice; the k-NN pipeline reads
    none of them."""
    device: Any = None
    train_engine: str = "scan"
    bottom_impl: str = "ref"
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
    (``None`` inherits the engine device through
    ``with_engine_defaults``)."""
    protocol: str = "rsa"
    psi_backend: str = "host"
    overlap: float = 0.7
    sort: Optional[str] = None
    impl: Optional[str] = None
    device: Any = None

    def with_engine_defaults(self, engine: EngineOptions) -> "AlignOptions":
        """Inherit the engine device when no alignment device was given."""
        if self.device is None and engine.device is not None:
            return dataclasses.replace(self, device=engine.device)
        return self
