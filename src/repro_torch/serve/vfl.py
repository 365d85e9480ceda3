"""Continuous-batching VFL scoring engine: the port of
``repro.serve.vfl``.

Aligned clients stream feature rows as *requests* (one request = one
user's batch of aligned rows, each row split into the M clients'
slices), and the engine scores them through the SAME packed-slab bottom
path the trainer uses — ``pack_slab_params`` + the ``splitnn_bottom``
kernel (K1) via ``train.vfl.make_score_step``.

A slot-based scheduler admits requests into a fixed-shape
``(M, slots, d_max)`` device batch:

- every dispatch has the same shape, with empty slots carrying
  don't-care rows whose outputs are discarded (in f32 each output row
  depends on its own input row only, so an occupied slot's output is the
  same at any occupancy; under a quant the wire rounding shares one
  exponent across each block of 8 slots, so a neighbour's row can move
  a row's output by up to one wire step, as in the reference);
- admission is FIFO **with backfill**: a request whose remaining rows
  fit the free slots is admitted whole; one that does not fit is
  deferred and later, smaller requests may fill the batch, so
  completion is out of order and head-of-line blocking does not empty
  the batch;
- starvation is bounded: after ``max_defer`` deferrals a request splits
  across dispatches (``stats.forced_splits``), and oversized requests
  (rows > slots) always stream;
- ``ServeStats`` counts dispatches, admitted rows, padded (empty)
  slot-steps and summed occupancy.

``score_partition`` is the offline/eval flavor — fixed ``block_b``-row
batches over a whole partition (zero-padded remainder, truncated), which
``splitnn.predict``/``evaluate`` route through.  ``quant`` ("int8"|
"fp8") scores under the wire rounding of quantized training (K9 in
every int8 dispatch).  ``simulate_trace`` drives an engine over an
open-loop arrival trace on a virtual clock under the ``"continuous"``
and ``"blocking"`` policies.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.obs.metrics import Histogram, StatsMixin
from repro_torch.obs.trace import span
from repro_torch.train.vfl import make_score_step, pack_slab

__all__ = [
    "ServeStats", "ScoreRequest", "VFLScoringEngine", "SimReport",
    "score_partition", "simulate_trace",
]


# ------------------------------------------------------------------ stats


@dataclasses.dataclass
class ServeStats(StatsMixin):
    """Measured execution counts for one scoring engine; every field is
    a deterministic function of the request trace and the scheduler
    knobs.  ``padded_slots`` counts empty slot-steps, ``occupancy_sum``
    the occupied slots summed over dispatches.  ``rejected_rows`` and
    ``eligible_updates`` count the eligibility filter's work (outside
    ``CONTRACT_FIELDS``, as in the reference)."""
    dispatches: int = 0
    admitted_rows: int = 0
    padded_slots: int = 0
    occupancy_sum: int = 0
    requests: int = 0
    completed: int = 0
    forced_splits: int = 0
    slots: int = 0
    bottom_impl: str = "ref"
    quant: str = "none"
    rejected_rows: int = 0
    eligible_updates: int = 0

    CONTRACT_FIELDS = ("dispatches", "admitted_rows", "padded_slots",
                       "occupancy_sum", "completed", "forced_splits")

    @property
    def mean_occupancy(self) -> float:
        return self.occupancy_sum / self.dispatches if self.dispatches else 0.0


@dataclasses.dataclass
class ScoreRequest:
    """One scoring request: ``features`` holds the M clients' aligned
    slices, each ``(rows, d_m)`` (or ``(d_m,)`` for a single row).
    ``arrival`` is the open-loop arrival time in virtual seconds — only
    ``simulate_trace`` reads it."""
    rid: int
    features: List[np.ndarray]
    arrival: float = 0.0


class _Pending:
    """Scheduler-internal per-request state: the request's rows packed
    into one (M, rows, d_max) block, the next row to admit, and the
    output buffer rows scatter into as their dispatches retire."""
    __slots__ = ("rid", "block", "n_rows", "next_row", "done", "out",
                 "deferrals")

    def __init__(self, rid: int, block: np.ndarray):
        self.rid = rid
        self.block = block
        self.n_rows = block.shape[1]
        self.next_row = 0
        self.done = 0
        self.out: Optional[np.ndarray] = None
        self.deferrals = 0


class VFLScoringEngine:
    """Slot-based continuous-batching scorer for a trained SplitNN.

    ``params`` is model-zoo form (``TrainReport.params``) on the device
    that scores; ``slots`` is the fixed device batch size.  Drive it
    with ``submit`` + ``step`` (one admission + dispatch round,
    returning the requests that completed), or ``score_requests`` to
    run a list to completion.  ``bottom_impl`` ``None`` picks the kernel
    on CUDA and the plain version on the CPU."""

    def __init__(self, params, cfg, feature_dims: Optional[Sequence[int]]
                 = None, *, slots: int = 64,
                 bottom_impl: Optional[str] = None, max_defer: int = 2,
                 quant: Optional[str] = None):
        if feature_dims is None:
            feature_dims = [bp["w"].shape[0] for bp in params["bottoms"]]
        self.cfg = cfg
        self.feature_dims = [int(d) for d in feature_dims]
        self.m = len(self.feature_dims)
        self.d_max = max(self.feature_dims)
        self.slots = int(slots)
        self.max_defer = int(max_defer)
        self.packed, self._score = make_score_step(
            params, cfg, self.feature_dims, bottom_impl=bottom_impl,
            quant=quant)
        self.device = self.packed["bw"].device
        self.stats = ServeStats(slots=self.slots,
                                bottom_impl=self._score.bottom_impl,
                                quant=self._score.quant or "none")
        self._xbuf = np.zeros((self.m, self.slots, self.d_max), np.float32)
        self._slot_req: List[Optional[_Pending]] = [None] * self.slots
        self._slot_row = np.zeros(self.slots, np.int64)
        self._queue: "collections.deque[_Pending]" = collections.deque()
        # None = no eligibility filter (every row scores); otherwise a
        # sorted id array maintained by the delta-PSI stream
        self._eligible: Optional[np.ndarray] = None

    @classmethod
    def from_report(cls, report, cfg, **kw) -> "VFLScoringEngine":
        """Engine straight off a ``TrainReport`` (the train→serve
        slab-params handoff)."""
        return cls(report.params, cfg, **kw)

    # ------------------------------------------------------------ state

    @property
    def free_slots(self) -> int:
        return sum(r is None for r in self._slot_req)

    @property
    def occupied_slots(self) -> int:
        return self.slots - self.free_slots

    @property
    def queued_rows(self) -> int:
        return sum(r.n_rows - r.next_row for r in self._queue)

    @property
    def has_work(self) -> bool:
        return self.occupied_slots > 0 or len(self._queue) > 0

    # ----------------------------------------------------- eligibility

    def set_eligible(self, ids: Optional[Sequence[int]]) -> None:
        """Install (or with ``None`` clear) the eligible-id filter —
        rows submitted with ``row_ids`` outside it are rejected."""
        self._eligible = (None if ids is None
                          else np.unique(np.asarray(ids, np.int64)))
        self.stats.eligible_updates += 1

    def apply_aligned_delta(self, added: Sequence[int],
                            removed: Sequence[int]) -> None:
        """Patch the eligible set with one aligned-set delta — queued
        and in-flight rows are unaffected."""
        cur = (self._eligible if self._eligible is not None
               else np.empty(0, np.int64))
        cur = np.setdiff1d(cur, np.asarray(removed, np.int64))
        self._eligible = np.union1d(cur, np.asarray(added, np.int64))
        self.stats.eligible_updates += 1

    # ------------------------------------------------------- submission

    def submit(self, rid: int, features: Sequence[np.ndarray],
               row_ids: Optional[Sequence[int]] = None) -> int:
        """Enqueue one request: the M clients' aligned slices, each
        (rows, d_m) or (d_m,) for a single row.  ``row_ids`` (one aligned
        id per row) lets the eligibility filter drop rows whose ids have
        left the aligned set; a request with no eligible rows is not
        enqueued.  Returns the number of rows enqueued."""
        feats = [np.atleast_2d(np.asarray(f, np.float32)) for f in features]
        if len(feats) != self.m:
            raise ValueError(f"expected {self.m} client slices, "
                             f"got {len(feats)}")
        rows = feats[0].shape[0]
        for f, d in zip(feats, self.feature_dims):
            if f.shape != (rows, d):
                raise ValueError(f"client slice {f.shape} != ({rows}, {d})")
        if row_ids is not None and self._eligible is not None:
            ids = np.asarray(row_ids, np.int64).reshape(-1)
            if ids.shape[0] != rows:
                raise ValueError(f"row_ids has {ids.shape[0]} entries "
                                 f"for {rows} rows")
            keep = np.isin(ids, self._eligible)
            self.stats.rejected_rows += int(rows - keep.sum())
            if not keep.any():
                return 0
            feats = [f[keep] for f in feats]
            rows = int(keep.sum())
        block = np.zeros((self.m, rows, self.d_max), np.float32)
        for i, f in enumerate(feats):
            block[i, :, :f.shape[1]] = f
        self._queue.append(_Pending(int(rid), block))
        self.stats.requests += 1
        return rows

    # -------------------------------------------------------- scheduler

    def admit(self) -> int:
        """Fill free slots from the queue: FIFO with backfill (see the
        module docstring).  Returns the number of rows admitted."""
        free = [s for s in range(self.slots) if self._slot_req[s] is None]
        sp = span("serve.admit", queued=len(self._queue), free=len(free))
        with sp:
            admitted = self._admit_into(free)
        sp.set(admitted=admitted)
        self.stats.admitted_rows += admitted
        return admitted

    def _admit_into(self, free: List[int]) -> int:
        admitted = 0
        for req in list(self._queue):
            if not free:
                break
            rem = req.n_rows - req.next_row
            if rem > len(free):
                splittable = rem > self.slots or req.deferrals >= self.max_defer
                if not splittable:
                    req.deferrals += 1
                    continue
                if rem <= self.slots:
                    self.stats.forced_splits += 1
            take = min(rem, len(free))
            for _ in range(take):
                s = free.pop(0)
                self._slot_req[s] = req
                self._slot_row[s] = req.next_row
                self._xbuf[:, s, :] = req.block[:, req.next_row, :]
                req.next_row += 1
            admitted += take
            if req.next_row == req.n_rows:
                self._queue.remove(req)
        return admitted

    def dispatch(self) -> List[Tuple[int, np.ndarray]]:
        """Score the current batch (one fixed-shape device dispatch),
        scatter outputs back to their requests, and return the
        ``(rid, outputs)`` pairs that completed — possibly out of
        submission order."""
        occ = [s for s in range(self.slots) if self._slot_req[s] is not None]
        if not occ:
            return []
        with span("serve.dispatch", occupancy=len(occ), slots=self.slots,
                  rows=len(occ), bottom_impl=self.stats.bottom_impl):
            x = torch.as_tensor(self._xbuf, device=self.device)
            out = self._score(self.packed, x).cpu().numpy()
        self.stats.dispatches += 1
        self.stats.occupancy_sum += len(occ)
        self.stats.padded_slots += self.slots - len(occ)
        finished: List[_Pending] = []
        for s in occ:
            req = self._slot_req[s]
            if req.out is None:
                req.out = np.empty((req.n_rows, out.shape[1]), np.float32)
            req.out[self._slot_row[s]] = out[s]
            req.done += 1
            self._slot_req[s] = None
            if req.done == req.n_rows:
                finished.append(req)
        completed = []
        for req in finished:
            self.stats.completed += 1
            completed.append((req.rid, req.out))
        return completed

    def step(self) -> List[Tuple[int, np.ndarray]]:
        """One scheduler round: admit, then dispatch if anything is
        batched."""
        self.admit()
        return self.dispatch()

    def score_requests(self, requests: Sequence[Tuple[int, Sequence[
            np.ndarray]]]) -> Dict[int, np.ndarray]:
        """Submit every (rid, features) pair and run the engine dry."""
        for rid, feats in requests:
            self.submit(rid, feats)
        results: Dict[int, np.ndarray] = {}
        while self.has_work:
            for rid, out in self.step():
                results[rid] = out
        return results


# ------------------------------------------------------- offline scoring


def score_partition(params, cfg, partition, *, block_b: int = 512,
                    bottom_impl: Optional[str] = None,
                    quant: Optional[str] = None) -> np.ndarray:
    """Score a whole ``VerticalPartition`` through fixed-shape batches of
    ``min(block_b, N)`` rows (the remainder zero-padded and truncated;
    in f32 row independence makes this exact, under a quant the padded
    tail shares its last block's exponent) on the params' device.  The
    slab goes to the device in one copy and the outputs come back in
    one, so the host syncs once per call.  Returns the raw (N, o) outputs."""
    fd = [f.shape[1] for f in partition.client_features]
    n = partition.n_samples
    if n == 0:
        top = params["top"]
        o = (top["b"] if cfg.model in ("lr", "linreg") else top["w2"]
             ).shape[-1]
        return np.zeros((0, o), np.float32)
    bs = min(int(block_b), n)
    packed, score = make_score_step(params, cfg, fd,
                                    bottom_impl=bottom_impl, quant=quant)
    dev = packed["bw"].device
    slab = torch.as_tensor(pack_slab(partition.client_features), device=dev)
    outs = []
    for s in range(0, n, bs):
        e = min(s + bs, n)
        if e - s == bs:
            xb = slab[:, s:e].contiguous()
        else:
            xb = slab.new_zeros((slab.shape[0], bs, slab.shape[2]))
            xb[:, :e - s] = slab[:, s:e]
        with span("serve.dispatch", rows=e - s, slots=bs,
                  occupancy=e - s, bottom_impl=score.bottom_impl):
            outs.append(score(packed, xb)[:e - s])
    return torch.cat(outs).cpu().numpy()


# ---------------------------------------------------------- trace driver


@dataclasses.dataclass
class SimReport:
    """One policy's run over one trace: per-request virtual latency,
    final counters, total virtual makespan and measured wall time;
    ``service_hist`` holds the per-dispatch service times on the virtual
    clock, ``wall_hist`` the measured wall time of every dispatch."""
    policy: str
    latencies: Dict[int, float]
    results: Dict[int, np.ndarray]
    stats: ServeStats
    makespan: float
    wall_seconds: float
    service_hist: Histogram = dataclasses.field(
        default_factory=lambda: Histogram("serve.service_s"))
    wall_hist: Histogram = dataclasses.field(
        default_factory=lambda: Histogram("serve.dispatch_wall_s"))

    def percentile(self, q: float) -> float:
        return float(np.percentile(np.asarray(list(self.latencies.values())),
                                   q)) if self.latencies else 0.0


def simulate_trace(engine: VFLScoringEngine, trace: Sequence[ScoreRequest],
                   *, policy: str = "continuous",
                   service_seconds: Union[float, Callable[[int], float],
                                          None] = None) -> SimReport:
    """Drive ``engine`` over an open-loop arrival ``trace`` (sorted by
    ``arrival``) on a virtual clock.  ``"continuous"`` dispatches
    whatever is batched after admitting every arrived request;
    ``"blocking"`` dispatches only when all slots fill (or the stream
    has ended).  ``service_seconds`` is the per-dispatch cost on the
    virtual clock: a float, a callable of the occupied-slot count, or
    ``None`` for each dispatch's measured wall time.  Latency per
    request = completion time − arrival time, both virtual."""
    if policy not in ("continuous", "blocking"):
        raise ValueError(policy)
    t = 0.0
    i = 0
    n = len(trace)
    arrivals: Dict[int, float] = {}
    latencies: Dict[int, float] = {}
    results: Dict[int, np.ndarray] = {}
    service_hist = Histogram("serve.service_s")
    wall_hist = Histogram("serve.dispatch_wall_s")
    wall0 = time.perf_counter()
    while True:
        while i < n and trace[i].arrival <= t:
            engine.submit(trace[i].rid, trace[i].features)
            arrivals[trace[i].rid] = trace[i].arrival
            i += 1
        engine.admit()
        occ = engine.occupied_slots
        if occ == 0 and i >= n and len(engine._queue) == 0:
            break
        drained = i >= n
        if policy == "continuous":
            fire = occ > 0
        else:
            fire = engine.free_slots == 0 or (drained and occ > 0)
        if fire:
            w0 = time.perf_counter()
            completed = engine.dispatch()
            dt_wall = time.perf_counter() - w0
            wall_hist.observe(dt_wall)
            dt = dt_wall
            if service_seconds is not None:
                dt = (service_seconds(occ) if callable(service_seconds)
                      else float(service_seconds))
            service_hist.observe(dt)
            t += dt
            for rid, out in completed:
                latencies[rid] = t - arrivals[rid]
                results[rid] = out
        elif i < n:
            t = max(t, trace[i].arrival)     # idle until the next arrival
        else:
            # blocking, drained, occ == 0 but deferred rows queued: the
            # next admit round will place them (all slots are free)
            continue
    return SimReport(policy=policy, latencies=latencies, results=results,
                     stats=engine.stats, makespan=t,
                     wall_seconds=time.perf_counter() - wall0,
                     service_hist=service_hist, wall_hist=wall_hist)
