"""Device PSI engine and incremental alignment (port of ``repro.psi``).

  engine — batched round executor: pads every TPSI pair of an MPSI
           round to one (pairs, P) batch and runs PRF tag evaluation +
           sorted-merge intersection on the device.
  delta  — LSM-style incremental alignment: per-party ``TagIndex``
           (leveled sorted runs + tombstones) and the ``DeltaMPSI``
           coordinator that keeps the live aligned set byte-identical
           to a full Tree-MPSI re-run while touching only the delta.

``run_psi`` is the topology-dispatching front door shared with the
``repro_torch.core.mpsi`` schedulers: one ``AlignOptions``-driven
signature for tree/path/star.  The reference's jit-cache helpers
(``dispatch_key`` and its cache) have no counterpart: PyTorch compiles
nothing per shape.
"""
from repro_torch.psi.delta import (AlignedDelta, DeltaMPSI, DeltaStats,
                                   TagIndex)
from repro_torch.psi.engine import (EngineRound, match_round, oprf_round,
                                    tag_words, union_merge)


def run_psi(id_sets, *, topology: str = "tree", options=None, **kw):
    """Run an MPSI over ``id_sets`` with the given ``topology``
    ("tree"|"path"|"star") and one ``options=AlignOptions(...)``
    object; extra kwargs (``bandwidth=``, ``use_he=``, ...) pass
    through to the scheduler.  Returns ``repro_torch.core.mpsi.MPSIStats``.
    """
    from repro_torch.core.mpsi import MPSI

    if topology not in MPSI:
        raise ValueError(f"unknown topology {topology!r}; "
                         f"expected one of {sorted(MPSI)}")
    if options is not None:
        kw["options"] = options
    return MPSI[topology](id_sets, **kw)


__all__ = ["AlignedDelta", "DeltaMPSI", "DeltaStats", "EngineRound",
           "TagIndex", "match_round", "oprf_round", "run_psi", "tag_words",
           "union_merge"]
