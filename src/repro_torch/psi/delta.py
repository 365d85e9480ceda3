"""Streaming delta-PSI: LSM-style incremental alignment, the port of
``repro.psi.delta`` (the reference's DESIGN.md §13).

The paper's Tree-MPSI aligns a *static* population — any join/leave
forces a full O(N) re-run.  This module keeps alignment live under
churn:

``TagIndex``
    Each party's id set as leveled sorted u64 runs, newest first.  A
    run entry encodes one id as ``key62 = (id << 1) | live`` — ``live=1``
    is a join, ``live=0`` a tombstone for a leave — so a run stays
    sorted by id and the *newest run containing an id* decides its
    membership (LSM semantics).  ``apply_delta(joins, leaves)`` only
    sorts the delta (O(Δ log Δ)) and prepends it as a run; once the run
    count passes ``max_runs``, compaction merges the smallest adjacent
    pair through the SAME merge kernel the intersection path runs
    (``engine.union_merge`` reads ``sorted_intersect``'s merged keys:
    the CUDA merge path at any P, its plain version on the CPU), with a
    bit-exact host merge as the ``psi_backend="host"`` parity path.  Tombstones drop only when the older side of a merge is the
    bottom run — below it nothing can be shadowed.

``DeltaMPSI``
    The coordinator.  Bootstraps via a full Tree-MPSI, then on every
    ``apply_delta(party, joins, leaves)`` re-intersects ONLY the delta:
    leaves drop out of the aligned set locally; join candidates are
    restricted by each other party's ``TagIndex`` (one batched
    ``match_round`` over every (party, run) pair — receiver tags are
    the run's key62s, senders probe both ``(id<<1)`` variants) and the
    restricted sets tree-reduce with Tree-MPSI's volume-aware pairing,
    one batched engine dispatch per round.  The live aligned set is
    byte-identical after every step to a full Tree-MPSI re-run over the
    current population (tests/test_torch_delta_psi.py holds it, and
    every counter, against the reference):

        aligned' = (aligned − leaves_eff) ∪ {x ∈ joins∖aligned :
                                             x ∈ S_q ∀ q ≠ p}  = ∩ S'_q

    Byte/message accounting extends the MPSI cost model: per-delta OPRF
    traffic against each other party's index (``oprf_accounting`` on the
    candidate set), tree-phase pair traffic, and the HE relay of the
    aligned-set delta (``_broadcast_result``).  Spans ``delta.apply``,
    ``delta.compact``, ``delta.intersect`` ride the shared obs timeline,
    and listeners (``subscribe`` / ``stream_into``) receive every
    ``AlignedDelta`` — ``repro_torch.serve.vfl`` consumes them to update
    the scoring engine's eligible population without a restart.

``DeltaMPSI`` accepts ONLY ``repro_torch.config.AlignOptions``: the
device backend runs on ``options.device`` (CUDA unless the caller names
the CPU) through ``psi/engine.match_round``/``union_merge``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.config import AlignOptions
from repro_torch.core.mpsi import (DEFAULT_BANDWIDTH, DEFAULT_LATENCY,
                                   _broadcast_result, _greedy_pairs,
                                   _net_time, tree_mpsi)
from repro_torch.core.tpsi import oprf_accounting
from repro_torch.obs.metrics import StatsMixin
from repro_torch.obs.trace import span
from repro_torch.psi import engine

MAX_ID = 1 << 61      # (id << 1) | live must stay inside the 62-bit tag space

__all__ = ["MAX_ID", "TagIndex", "DeltaStats", "AlignedDelta", "DeltaMPSI"]


def _canonical_ids(ids) -> np.ndarray:
    arr = np.unique(np.asarray(ids, np.int64).reshape(-1))
    if arr.size and (arr[0] < 0 or arr[-1] >= MAX_ID):
        raise ValueError(f"delta-PSI ids must be in [0, 2^61); got "
                         f"[{arr[0]}, {arr[-1]}]")
    return arr


def _resolve_merged(merged: np.ndarray, bottom: bool) -> np.ndarray:
    """Newest-wins resolution of a merged run: ``merged`` holds sorted
    FULL keys ``(key62 << 1) | origin`` (origin 1 = newer run).  Each
    side has at most one entry per id, so a duplicated id is an
    adjacent pair; the origin-0 (older) entry loses.  ``bottom`` drops
    surviving tombstones — legal only when the older side was the
    oldest run."""
    ids = merged >> np.uint64(2)
    newer = (merged & np.uint64(1)).astype(bool)
    dup = ids[1:] == ids[:-1]
    drop = np.zeros(merged.shape, bool)
    drop[:-1] |= dup & ~newer[:-1]
    drop[1:] |= dup & ~newer[1:]
    key62 = (merged >> np.uint64(1))[~drop]
    if bottom:
        key62 = key62[(key62 & np.uint64(1)) == np.uint64(1)]
    return key62


class TagIndex:
    """One party's id set as leveled sorted u64 tag runs + tombstones.

    ``runs[0]`` is the newest; membership of an id is the live bit of
    its entry in the newest run that mentions it.  All mutators keep
    every run sorted and id-unique, so lookups are ``searchsorted`` and
    compaction is one bitonic merge."""

    def __init__(self, ids: Sequence[int] = (), *,
                 options: Optional[AlignOptions] = None, max_runs: int = 8):
        if max_runs < 2:
            raise ValueError("max_runs must be >= 2")
        self.options = options or AlignOptions()
        self.max_runs = int(max_runs)
        self.compactions = 0
        base = _canonical_ids(ids)
        self.runs: List[np.ndarray] = []
        if base.size:
            self.runs.append(((base.astype(np.uint64) << np.uint64(1))
                              | np.uint64(1)))

    # ------------------------------------------------------------- mutation

    def apply_delta(self, joins: Sequence[int] = (),
                    leaves: Sequence[int] = ()) -> None:
        """Insert one sorted run for this delta — O(Δ log Δ).  An id in
        both ``joins`` and ``leaves`` joins (the leave is stale by
        protocol order); duplicates and already-present ids are
        harmless under newest-wins."""
        joins = _canonical_ids(joins)
        leaves = _canonical_ids(leaves)
        leaves_eff = np.setdiff1d(leaves, joins, assume_unique=True)
        run = np.concatenate([
            (joins.astype(np.uint64) << np.uint64(1)) | np.uint64(1),
            leaves_eff.astype(np.uint64) << np.uint64(1)])
        run.sort()
        if run.size:
            self.runs.insert(0, run)
        if len(self.runs) > self.max_runs:
            self.compact()

    def compact(self, full: bool = False) -> None:
        """Merge runs until ``max_runs`` remain (or one, with
        ``full=True``), always folding the smallest adjacent pair so
        the big bottom run is touched only when it is itself part of
        the cheapest merge."""
        target = 1 if full else self.max_runs
        while len(self.runs) > target:
            sizes = [r.size for r in self.runs]
            i = min(range(len(self.runs) - 1),
                    key=lambda j: sizes[j] + sizes[j + 1])
            self._merge_pair(i)

    def _merge_pair(self, i: int) -> None:
        newer, older = self.runs[i], self.runs[i + 1]
        bottom = (i + 1) == len(self.runs) - 1
        with span("delta.compact", newer=int(newer.size),
                  older=int(older.size), bottom=bottom,
                  backend=self.options.psi_backend):
            if self.options.psi_backend == "device":
                merged = engine.union_merge(newer, older,
                                            options=self.options)
            else:
                merged = np.sort(np.concatenate([
                    (newer << np.uint64(1)) | np.uint64(1),
                    older << np.uint64(1)]))
            self.runs[i:i + 2] = [_resolve_merged(merged, bottom)]
        self.compactions += 1

    # -------------------------------------------------------------- queries

    def contains(self, ids: Sequence[int]) -> np.ndarray:
        """Newest-wins membership for a sorted-or-not id array."""
        q = np.asarray(ids, np.int64).astype(np.uint64) << np.uint64(1)
        out = np.zeros(q.shape, bool)
        undecided = np.ones(q.shape, bool)
        for run in self.runs:
            if not undecided.any() or not run.size:
                continue
            idx = np.searchsorted(run, q)
            valid = idx < run.size
            entry = run[np.minimum(idx, run.size - 1)]
            hit = valid & ((entry >> np.uint64(1)) == (q >> np.uint64(1)))
            found = undecided & hit
            out[found] = (entry[found] & np.uint64(1)).astype(bool)
            undecided &= ~hit
        return out

    def materialize(self) -> np.ndarray:
        """The current id set as sorted int64 — the ground truth a full
        Tree-MPSI re-run would see."""
        if not self.runs:
            return np.empty(0, np.int64)
        keys = np.concatenate(self.runs)
        prio = np.concatenate([np.full(r.size, i, np.int64)
                               for i, r in enumerate(self.runs)])
        ids = (keys >> np.uint64(1)).astype(np.int64)
        order = np.lexsort((prio, ids))
        ids_s = ids[order]
        first = np.ones(order.size, bool)
        first[1:] = ids_s[1:] != ids_s[:-1]
        live = (keys[order] & np.uint64(1)).astype(bool)
        return ids_s[first & live]

    def __len__(self) -> int:
        return int(self.materialize().size)


# ------------------------------------------------------------- coordinator

@dataclasses.dataclass
class DeltaStats(StatsMixin):
    """Cumulative incremental-alignment stats: the bootstrap Tree-MPSI
    plus every applied delta, in the same units as ``MPSIStats`` so the
    fig7 amortized-cost curves subtract cleanly."""
    aligned: np.ndarray
    deltas_applied: int = 0
    rounds: int = 0
    total_bytes: int = 0
    total_messages: int = 0
    simulated_seconds: float = 0.0
    compute_seconds: float = 0.0
    device_dispatches: int = 0
    compactions: int = 0
    bootstrap_bytes: int = 0
    bootstrap_seconds: float = 0.0


@dataclasses.dataclass(frozen=True)
class AlignedDelta:
    """One aligned-set update, streamed to subscribers (``serve.vfl``
    consumes ``added``/``removed`` to patch its eligible set)."""
    party: int
    added: np.ndarray
    removed: np.ndarray
    aligned: np.ndarray
    version: int


class DeltaMPSI:
    """Incremental Tree-MPSI coordinator over ``m`` parties' indexes.

    Takes ONLY ``options=repro_torch.config.AlignOptions(...)``, which
    selects protocol, backend, impl, device and mesh exactly as for
    ``tree_mpsi`` (``psi_backend="device"`` batches index queries and
    tree rounds through ``psi/engine.match_round``, sharding over
    ``options.mesh``).
    """

    def __init__(self, id_sets: Sequence[np.ndarray], *,
                 options: Optional[AlignOptions] = None,
                 bandwidth: Optional[float] = None,
                 latency: Optional[float] = None,
                 use_he: bool = True, max_runs: int = 8):
        if options is not None and not isinstance(options, AlignOptions):
            raise TypeError(
                "DeltaMPSI takes options=repro_torch.config.AlignOptions"
                "(...)")
        if len(id_sets) < 2:
            raise ValueError("DeltaMPSI needs at least two parties")
        self.options = options or AlignOptions()
        self.bandwidth = float(DEFAULT_BANDWIDTH if bandwidth is None
                               else bandwidth)
        self.latency = float(DEFAULT_LATENCY if latency is None
                             else latency)
        self.use_he = bool(use_he)
        self.n_parties = len(id_sets)
        with span("delta.bootstrap", parties=self.n_parties):
            boot = tree_mpsi(id_sets, bandwidth=self.bandwidth,
                             latency=self.latency, use_he=self.use_he,
                             options=self.options)
        self.indexes = [TagIndex(s, options=self.options,
                                 max_runs=max_runs) for s in id_sets]
        self.aligned = np.asarray(boot.intersection, np.int64)
        self.bootstrap = boot
        self.version = 0
        self._listeners: List[Callable[[AlignedDelta], None]] = []
        self.stats = DeltaStats(
            aligned=self.aligned, rounds=boot.rounds,
            total_bytes=boot.total_bytes,
            total_messages=boot.total_messages,
            simulated_seconds=boot.simulated_seconds,
            compute_seconds=boot.compute_seconds,
            device_dispatches=boot.device_dispatches,
            bootstrap_bytes=boot.total_bytes,
            bootstrap_seconds=boot.simulated_seconds)

    # ----------------------------------------------------------- streaming

    def subscribe(self, listener: Callable[[AlignedDelta], None]
                  ) -> Callable[[AlignedDelta], None]:
        """Register a callback for every applied delta; returns the
        listener (usable as a decorator)."""
        self._listeners.append(listener)
        return listener

    def stream_into(self, scoring_engine) -> None:
        """Wire the live aligned set into a ``repro_torch.serve.vfl``
        ``VFLScoringEngine``: seed its eligible population now and
        stream every subsequent delta."""
        scoring_engine.set_eligible(self.aligned)
        self.subscribe(lambda d: scoring_engine.apply_aligned_delta(
            d.added, d.removed))

    def party_set(self, party: int) -> np.ndarray:
        """The party's CURRENT id set (materialized from its index) —
        what a full re-run would consume."""
        return self.indexes[party].materialize()

    # ------------------------------------------------------------ protocol

    def apply_delta(self, party: int, joins: Sequence[int] = (),
                    leaves: Sequence[int] = ()) -> AlignedDelta:
        """Apply one party's join/leave delta and return the aligned-set
        update.  After this call ``self.aligned`` equals
        ``tree_mpsi([party_set(q) for q])`` bit-for-bit."""
        if not 0 <= party < self.n_parties:
            raise ValueError(f"party {party} out of range")
        joins = _canonical_ids(joins)
        leaves = _canonical_ids(leaves)
        t0 = time.perf_counter()
        compactions0 = self.indexes[party].compactions
        with span("delta.apply", party=party, joins=int(joins.size),
                  leaves=int(leaves.size)):
            self.indexes[party].apply_delta(joins, leaves)

        leaves_eff = np.setdiff1d(leaves, joins, assume_unique=True)
        removed = np.intersect1d(self.aligned, leaves_eff,
                                 assume_unique=True)
        cand = np.setdiff1d(joins, self.aligned, assume_unique=True)
        others = [q for q in range(self.n_parties) if q != party]

        d_bytes = d_msgs = dispatches = 0
        rounds = 0
        sim_net = 0.0
        added = np.empty(0, np.int64)
        if cand.size:
            with span("delta.intersect", party=party, cand=int(cand.size),
                      parties=len(others)) as sp:
                restricted, q_disp = self._query_members(cand, others)
                dispatches += q_disp
                rounds += 1
                query_net = []
                for q in others:
                    b_s, b_r, msgs = oprf_accounting(cand.size, cand.size)
                    d_bytes += b_s + b_r
                    d_msgs += msgs
                    query_net.append(_net_time(b_s + b_r, self.bandwidth,
                                               self.latency, msgs))
                sim_net += max(query_net, default=0.0)
                (added, t_rounds, t_bytes, t_msgs, t_net,
                 t_disp) = self._tree_reduce(
                     [restricted[q] for q in others])
                rounds += t_rounds
                d_bytes += t_bytes
                d_msgs += t_msgs
                sim_net += t_net
                dispatches += t_disp
                sp.set(added=int(added.size), comm_bytes=d_bytes)

        new_aligned = np.union1d(
            np.setdiff1d(self.aligned, removed, assume_unique=True), added)
        delta_ids = np.sort(np.concatenate([added, removed]))
        b_bytes, b_msgs, b_secs = _broadcast_result(
            delta_ids, self.n_parties, use_he=self.use_he,
            bandwidth=self.bandwidth, latency=self.latency)

        wall = time.perf_counter() - t0
        self.aligned = new_aligned
        self.version += 1
        st = self.stats
        st.aligned = new_aligned
        st.deltas_applied += 1
        st.rounds += rounds
        st.total_bytes += d_bytes + b_bytes
        st.total_messages += d_msgs + b_msgs
        st.compute_seconds += wall
        st.simulated_seconds += wall + sim_net + b_secs
        st.device_dispatches += dispatches
        st.compactions += (self.indexes[party].compactions - compactions0)

        update = AlignedDelta(party=party, added=added, removed=removed,
                              aligned=new_aligned, version=self.version)
        for listener in self._listeners:
            listener(update)
        return update

    # ------------------------------------------------------------ internals

    def _query_members(self, cand: np.ndarray, others: Sequence[int]
                       ) -> Tuple[Dict[int, np.ndarray], int]:
        """Restrict the candidate set by every other party's index.

        Device backend: ONE batched ``match_round`` over all (party,
        run) pairs — receiver tags/payloads are the run's key62 entries
        (unique within a run), the sender probes both variants
        ``(id<<1)`` and ``(id<<1)|1`` of every candidate; per party the
        matches resolve newest-run-first, live bit deciding.  Host
        backend: the same newest-wins query via ``TagIndex.contains``.
        """
        if self.options.psi_backend != "device":
            return ({q: cand[self.indexes[q].contains(cand)]
                     for q in others}, 0)
        r_tags: List[np.ndarray] = []
        meta: List[Tuple[int, int]] = []
        for q in others:
            for ri, run in enumerate(self.indexes[q].runs):
                r_tags.append(run.astype(np.int64))
                meta.append((q, ri))
        if not r_tags:
            return {q: np.empty(0, np.int64) for q in others}, 0
        variants = np.sort(np.concatenate([
            cand.astype(np.uint64) << np.uint64(1),
            (cand.astype(np.uint64) << np.uint64(1)) | np.uint64(1),
        ])).astype(np.int64)
        rnd = engine.match_round(r_tags, r_tags,
                                 [variants] * len(r_tags),
                                 options=self.options)
        restricted: Dict[int, np.ndarray] = {}
        for q in others:
            member = np.zeros(cand.shape, bool)
            undecided = np.ones(cand.shape, bool)
            for j, (mq, _) in enumerate(meta):
                if mq != q:
                    continue       # meta is run-index ascending per party
                keys = rnd.intersections[j].astype(np.uint64)
                ids = (keys >> np.uint64(1)).astype(np.int64)
                live = (keys & np.uint64(1)).astype(bool)
                pos = np.searchsorted(cand, ids)
                upd = undecided[pos]
                member[pos[upd]] = live[upd]
                undecided[pos] = False
            restricted[q] = cand[member]
        return restricted, rnd.dispatches

    def _tree_reduce(self, sets: List[np.ndarray]
                     ) -> Tuple[np.ndarray, int, int, int, float, int]:
        """Tree-MPSI-style reduction of the restricted candidate sets:
        volume-aware greedy pairing, one batched engine dispatch per
        round on the device backend, OPRF-model accounting per pair.

        Returns (intersection, rounds, bytes, messages,
        summed round net makespans, dispatches)."""
        holdings = [np.asarray(s, np.int64) for s in sets]
        rounds = total_bytes = total_msgs = dispatches = 0
        net = 0.0
        while len(holdings) > 1:
            order = sorted(range(len(holdings)),
                           key=lambda i: holdings[i].size)
            pairs, passthrough = _greedy_pairs(order)
            r_sets: List[np.ndarray] = []
            s_sets: List[np.ndarray] = []
            round_net: List[float] = []
            for a, b in pairs:
                small, big = ((a, b) if holdings[a].size <= holdings[b].size
                              else (b, a))
                # OPRF role rule: larger side receives (tpsi docstring)
                r_sets.append(holdings[big])
                s_sets.append(holdings[small])
                b_s, b_r, msgs = oprf_accounting(holdings[small].size,
                                                 holdings[big].size)
                total_bytes += b_s + b_r
                total_msgs += msgs
                round_net.append(_net_time(b_s + b_r, self.bandwidth,
                                           self.latency, msgs))
            if self.options.psi_backend == "device":
                rnd = engine.match_round(r_sets, r_sets, s_sets,
                                         options=self.options)
                inters = rnd.intersections
                dispatches += rnd.dispatches
            else:
                inters = [np.intersect1d(r, s, assume_unique=True)
                          for r, s in zip(r_sets, s_sets)]
            if passthrough is not None:
                inters = inters + [holdings[passthrough]]
            holdings = inters
            rounds += 1
            net += max(round_net, default=0.0)
        result = holdings[0] if holdings else np.empty(0, np.int64)
        return result, rounds, total_bytes, total_msgs, net, dispatches
