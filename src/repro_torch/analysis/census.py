"""Program census: what one call of an engine program does, read by
running it (the port of ``repro.analysis.census``).

The reference traces a program to a jaxpr and walks it without running
it.  Eager PyTorch has no program to walk, so the port runs the program
once under a ``TorchDispatchMode`` (which sees every aten op, on the CPU
as on the card, deterministically) and reads the collective counts
(``sharding.COLLECTIVES``, per kind) and the kernel launches
(``kernels.build.LAUNCHES``) before and after.  It counts:

- collectives by the reference's kinds (``all_gather`` / ``psum`` /
  ``reduce_scatter`` / ``ppermute`` / ``all_to_all``), their calls and
  their output bytes, and the calls and bytes a step of the engine's
  loop makes (``_in_loop``; the one-all-gather-a-step contract);
- host syncs, the counterpart of the reference's host callbacks:
  ``aten._local_scalar_dense`` (``.item()``, ``float(t)``, ``int(t)``,
  ``bool(t)``), ``Tensor.tolist`` and copies from the program's device
  to the host; each is also classed as inside a step body or not, by the
  table of step bodies the lint reads (``lint.STEP_BODIES``), so the
  epoch's one sync counts apart from the steps';
- f64: every op output of dtype float64 (``f64_values``) and every cast
  to it (``f64_widenings``);
- kernel launches, per kernel name (``kernel_launches``, the
  counterpart of ``pallas_calls``; zero on the CPU, where the ops take
  the plain versions), and a step's;
- ``steps``, the engine's steps a round of its loop (the reference's
  ``scan_lengths``).

The reference's ``while_loops`` and ``donated_args`` have no counterpart
(eager PyTorch has neither a while primitive nor buffer donation) and
are dropped.

**Loops.**  The port's loops are Python ``for`` loops (an epoch's steps,
Lloyd's iterations).  A census with ``steps`` runs the program twice,
``fn(*args, rounds=1)`` and ``fn(*args, rounds=2)``: a program whose
loop runs ``rounds`` times ``steps`` steps.  The difference of the two
is one round's worth; divided by ``steps`` it is what a step makes,
which must be a whole number (asserted).  The host syncs a round makes
outside its steps (the epoch's one sync) are ``round_syncs``.  Every
field without ``_in_loop`` counts one call with the loop's body counted
once, as the reference's structural counts do: the first call's counts
less the steps after the first.

**Meshes.**  On a mesh every rank takes the census of its own run; the
census asserts that all ranks of the default process group agree, then
returns rank 0's.
"""
from __future__ import annotations

import dataclasses
import sys
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.analysis.lint import STEP_BODIES
from repro_torch.sharding import COLLECTIVE_KINDS, COLLECTIVES

__all__ = ["CENSUS_FIELDS", "COLLECTIVE_KINDS", "ProgramCensus",
           "census_program"]

# the flat counter schema shared by the contract, the census CSV and
# the gate (``repro_torch.analysis.check``)
CENSUS_FIELDS: Tuple[str, ...] = tuple(
    [f"{k}{suffix}" for k in COLLECTIVE_KINDS
     for suffix in ("", "_in_loop", "_bytes", "_bytes_in_loop")]
    + ["host_syncs", "host_syncs_in_loop", "round_syncs", "f64_values",
       "f64_widenings", "kernel_launches", "kernel_launches_in_loop",
       "steps"])

_aten = torch.ops.aten


@dataclasses.dataclass
class ProgramCensus:
    """What one call of a program does (module docstring)."""
    collectives: Dict[str, int] = dataclasses.field(default_factory=dict)
    collectives_in_loop: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    collective_bytes: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    collective_bytes_in_loop: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    host_syncs: int = 0
    host_syncs_in_loop: int = 0
    round_syncs: int = 0
    f64_values: int = 0
    f64_widenings: int = 0
    kernel_launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    kernel_launches_in_loop: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    steps: int = 0
    #: ``torch.cuda.set_sync_debug_mode`` warnings (CUDA programs only;
    #: not a contract field): of one call outside steps, and a step's
    sync_warnings: int = 0
    sync_warnings_in_loop: int = 0

    def counters(self) -> Dict[str, Any]:
        """The flat ``CENSUS_FIELDS`` dict the contract pins."""
        out: Dict[str, Any] = {}
        for k in COLLECTIVE_KINDS:
            out[k] = self.collectives.get(k, 0)
            out[f"{k}_in_loop"] = self.collectives_in_loop.get(k, 0)
            out[f"{k}_bytes"] = self.collective_bytes.get(k, 0)
            out[f"{k}_bytes_in_loop"] = \
                self.collective_bytes_in_loop.get(k, 0)
        out["host_syncs"] = self.host_syncs
        out["host_syncs_in_loop"] = self.host_syncs_in_loop
        out["round_syncs"] = self.round_syncs
        out["f64_values"] = self.f64_values
        out["f64_widenings"] = self.f64_widenings
        out["kernel_launches"] = dict(sorted(self.kernel_launches.items()))
        out["kernel_launches_in_loop"] = dict(
            sorted(self.kernel_launches_in_loop.items()))
        out["steps"] = self.steps
        return out

    def total_collectives(self) -> int:
        return sum(self.collectives.values())


def _in_step_body() -> bool:
    """Whether the caller runs inside a step body of ``STEP_BODIES``
    (a frame of one of its functions is on the stack)."""
    frame = sys._getframe(1)
    while frame is not None:
        code = frame.f_code
        names = _STEP_FILES.get(code.co_filename)
        if names is None:
            names = _STEP_FILES[code.co_filename] = _step_names(
                code.co_filename)
        if code.co_qualname.replace(".<locals>", "") in names:
            return True
        frame = frame.f_back
    return False


_STEP_FILES: Dict[str, frozenset] = {}


def _step_names(filename: str) -> frozenset:
    path = filename.replace("\\", "/")
    return frozenset(name for suffix, names in STEP_BODIES.items()
                     if path.endswith("repro_torch/" + suffix)
                     for name in names)


@dataclasses.dataclass
class _Counts:
    syncs: int = 0
    syncs_in_step: int = 0
    f64_values: int = 0
    f64_widenings: int = 0
    warns: int = 0
    warns_in_step: int = 0


def _is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


class _Recorder(TorchDispatchMode):
    """Counts host syncs and f64 at the aten level."""

    def __init__(self, counts: _Counts):
        super().__init__()
        self.c = counts
        self.quiet = 0             # inside a Tensor.tolist already counted

    def sync(self) -> None:
        self.c.syncs += 1
        self.c.syncs_in_step += int(_in_step_body())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self.quiet:
            if func is _aten._local_scalar_dense.default:
                self.sync()
            elif func in (_aten._to_copy.default, _aten.copy_.default):
                src = args[1] if func is _aten.copy_.default else args[0]
                dst = args[0] if func is _aten.copy_.default else out
                if (_is_tensor(src) and _is_tensor(dst)
                        and src.device.type != "cpu"
                        and dst.device.type == "cpu"):
                    self.sync()
        if func is _aten._to_copy.default and _is_tensor(out) and \
                out.dtype == torch.float64 and args[0].dtype != torch.float64:
            self.c.f64_widenings += 1
        for t in tree_flatten(out)[0]:
            if _is_tensor(t) and t.dtype == torch.float64:
                self.c.f64_values += 1
        return out


class _ListRecorder(TorchFunctionMode):
    """Counts ``Tensor.tolist`` (which reads the data without an aten op
    on the CPU) as one host sync, and nothing inside it."""

    def __init__(self, rec: _Recorder):
        super().__init__()
        self.rec = rec

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is torch.Tensor.tolist:
            self.rec.sync()
            self.rec.quiet += 1
            try:
                return func(*args, **(kwargs or {}))
            finally:
                self.rec.quiet -= 1
        return func(*args, **(kwargs or {}))


def _snapshot() -> Dict[str, int]:
    from repro_torch.kernels.build import LAUNCHES
    return {**{f"coll:{k}": v for k, v in COLLECTIVES.items()},
            **{f"launch:{k}": v for k, v in LAUNCHES.items()}}


def _run_once(fn: Callable, args, kwargs, sync_debug: bool
              ) -> Tuple[Dict[str, int], _Counts]:
    """Counters of one run of ``fn``: the differences of the collective
    and launch counts, and the recorder's counts."""
    counts = _Counts()
    before = _snapshot()
    rec = _Recorder(counts)
    with warnings.catch_warnings():
        if sync_debug:
            warnings.simplefilter("always")
            shown = warnings.showwarning

            def hook(message, category, *a, **k):
                if "synchroniz" in str(message):
                    counts.warns += 1
                    counts.warns_in_step += int(_in_step_body())
                else:
                    shown(message, category, *a, **k)
            warnings.showwarning = hook
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
        try:
            with _ListRecorder(rec), rec:
                fn(*args, **kwargs)
        finally:
            if sync_debug:
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode(mode)
    after = _snapshot()
    return {k: after[k] - before[k] for k in after}, counts


def _per_step(diff: int, steps: int, what: str) -> int:
    if diff % steps:
        raise AssertionError(f"census: {what} changes by {diff} a round of "
                             f"{steps} steps, not a whole number a step")
    return diff // steps


def _agree(census: ProgramCensus) -> ProgramCensus:
    """Rank 0's census, after asserting that every rank's is the same."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()) or \
            dist.get_world_size() == 1:
        return census
    every: List[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(every, dataclasses.asdict(census))
    bad = [r for r, c in enumerate(every) if c != every[0]]
    if bad:
        raise AssertionError(f"census: ranks {bad} disagree with rank 0: "
                             f"{[every[r] for r in bad]} vs {every[0]}")
    return census


def census_program(fn: Callable, *args, steps: Optional[int] = None,
                   sync_debug: bool = False, **kwargs) -> ProgramCensus:
    """Run ``fn(*args, **kwargs)`` once under the census and count what
    it did.  With ``steps``, ``fn`` is a loop program run as
    ``fn(*args, rounds=1)`` and ``fn(*args, rounds=2)``, ``steps`` steps
    a round (module docstring).  ``sync_debug`` (a CUDA program) also
    counts ``torch.cuda.set_sync_debug_mode("warn")``'s warnings."""
    if steps is None:
        diff, c = _run_once(fn, args, kwargs, sync_debug)
        one = {k: 0 for k in diff}
        syncs, syncs_loop, round_syncs = c.syncs, 0, 0
        warns, warns_loop = c.warns, 0
        f64 = (c.f64_values, c.f64_widenings)
    else:
        if steps < 1:
            raise ValueError(f"census: steps must be >= 1, got {steps}")
        diff, c = _run_once(fn, args, {**kwargs, "rounds": 1}, sync_debug)
        diff2, c2 = _run_once(fn, args, {**kwargs, "rounds": 2}, sync_debug)
        one = {k: _per_step(diff2[k] - diff[k], steps, k) for k in diff}
        # the first call's counts, the loop's body counted once
        diff = {k: diff[k] - (steps - 1) * one[k] for k in diff}
        syncs_loop = _per_step(c2.syncs_in_step - c.syncs_in_step, steps,
                               "host syncs inside steps")
        round_syncs = (c2.syncs - c2.syncs_in_step) - (c.syncs
                                                       - c.syncs_in_step)
        syncs = c.syncs - (steps - 1) * syncs_loop
        warns_loop = _per_step(c2.warns_in_step - c.warns_in_step, steps,
                               "sync warnings inside steps")
        warns = c.warns - (steps - 1) * warns_loop
        f64 = (c.f64_values, c.f64_widenings)
    census = ProgramCensus(
        collectives={k: diff[f"coll:{k}"] for k in COLLECTIVE_KINDS
                     if diff[f"coll:{k}"]},
        collectives_in_loop={k: one[f"coll:{k}"] for k in COLLECTIVE_KINDS
                             if one[f"coll:{k}"]},
        collective_bytes={k: diff[f"coll:{k}_bytes"]
                          for k in COLLECTIVE_KINDS
                          if diff[f"coll:{k}_bytes"]},
        collective_bytes_in_loop={k: one[f"coll:{k}_bytes"]
                                  for k in COLLECTIVE_KINDS
                                  if one[f"coll:{k}_bytes"]},
        host_syncs=syncs, host_syncs_in_loop=syncs_loop,
        round_syncs=round_syncs, f64_values=f64[0], f64_widenings=f64[1],
        kernel_launches={k[len("launch:"):]: v for k, v in diff.items()
                         if k.startswith("launch:") and v},
        kernel_launches_in_loop={k[len("launch:"):]: v
                                 for k, v in one.items()
                                 if k.startswith("launch:") and v},
        steps=steps or 0, sync_warnings=warns,
        sync_warnings_in_loop=warns_loop)
    return _agree(census)
