"""Open-loop arrivals on the VFL scoring engine: the ``score`` driver.

Requests arrive as a Poisson stream at ``offered_rows_per_s`` rows a
second on ``repro_torch.serve.vfl.VFLScoringEngine`` (``submit`` +
``step``, with ``slots`` slots and ``max_defer``), whether or not the
engine keeps up: a request is ``rows_min`` to ``rows_max`` aligned
rows, drawn uniformly, of the test split (``benchmarks/serve_vfl.py``'s
``make_trace``, rewritten here).  The stream is drawn from ``--seed``
in order, so the i-th request of a seed is always the same, with the
same arrival time.  The SplitNN's weights are made from ``--seed`` on
the card, in one draw, at the configuration's shapes; the same weights
go to the reference.  The warm-up scores requests of a stream of its
own, untimed.

The window counts the rows of the requests that returned to their
clients; a request's latency runs from its arrival to its return.  The
requests still in the engine at the window's close are then run to
their end (untimed, a minute at most) and compared like the rest.
Every request's output rows are compared with the reference.
"""
from __future__ import annotations

import time
from typing import List

import numpy as np
import torch

from perfbench.harness.profile import DeviceWindow
from perfbench.reference import vfl as ref
from perfbench.reference.data import make_partitions
from perfbench.rooflines import bottom_kernel

BLOCK = 1 << 16          # requests drawn at a time


def make_weights(mdl: dict, dims: List[int], seed: int, device) -> dict:
    """The SplitNN's weights from ``seed``, f32 on ``device``, in one
    draw: normals scaled by fan-in, biases normal at 0.1 (so that they
    take part)."""
    m = len(dims)
    o = int(mdl["bottom_dim"]) if mdl["model"] == "mlp" else ref.n_out(mdl)
    hd, c = int(mdl["hidden_dim"]), ref.n_out(mdl)
    shapes = []
    for d in dims:
        shapes += [("w", (d, o), d ** -0.5)]
        if mdl["model"] == "mlp":
            shapes += [("b", (o,), 0.1)]
    if mdl["model"] == "mlp":
        top = [("w1", (m * o, hd), (m * o) ** -0.5), ("b1", (hd,), 0.1),
               ("w2", (hd, c), hd ** -0.5), ("b2", (c,), 0.1)]
    else:
        top = [("b", (c,), 0.1)]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    total = sum(int(np.prod(s)) for _, s, _ in shapes + top)
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32)
    pieces, at = [], 0
    for name, shape, scale in shapes + top:
        n = int(np.prod(shape))
        pieces.append((name, flat[at:at + n].view(shape) * scale))
        at += n
    per = len(shapes) // m
    bottoms = [dict(pieces[i * per:(i + 1) * per]) for i in range(m)]
    return {"bottoms": bottoms, "top": dict(pieces[m * per:])}


class Traffic:
    """The request stream of one seed, drawn ``BLOCK`` requests at a
    time: request ``g``'s row count, rows (each client's slice of the
    block's rows gathered once, a request taking views of it) and
    arrival, and, in arrays of the block, its latency and output rows,
    so that a window of a million requests keeps no object per
    request."""

    def __init__(self, rows, mix: dict, o: int, rng: np.random.Generator):
        self.rows = rows
        self.lo, self.hi = int(mix["rows_min"]), int(mix["rows_max"])
        rate = float(mix["offered_rows_per_s"])
        self.gap = (self.lo + self.hi) / 2.0 / rate   # between requests
        self.o = o
        self.rng = rng
        self.blocks: list = []
        self.next = 0
        self.last = 0.0

    def _block(self, g: int) -> dict:
        while g // BLOCK >= len(self.blocks):
            counts = self.rng.integers(self.lo, self.hi + 1, size=BLOCK)
            idx = self.rng.integers(0, self.rows[0].shape[0],
                                    size=int(counts.sum()))
            arrival = self.last + np.cumsum(
                self.rng.exponential(self.gap, size=BLOCK))
            self.last = float(arrival[-1])
            self.blocks.append({
                "starts": np.concatenate(([0], np.cumsum(counts))),
                "idx": idx, "rows": [f[idx] for f in self.rows],
                "arrival": arrival,
                "latency": np.full(BLOCK, np.nan),
                "out": np.full((idx.size, self.o), np.nan, np.float32),
                "ok": np.zeros(BLOCK, bool)})
        return self.blocks[g // BLOCK]

    def arrival(self, g: int) -> float:
        """Request ``g``'s arrival, in seconds from the stream's start."""
        return float(self._block(g)["arrival"][g % BLOCK])

    def new(self) -> int:
        """The next request."""
        self.next += 1
        return self.next - 1

    def span(self, g: int):
        b = self._block(g)
        i = g % BLOCK
        return b, i, int(b["starts"][i]), int(b["starts"][i + 1])

    def features(self, g: int) -> List[np.ndarray]:
        b, _, s, e = self.span(g)
        return [r[s:e] for r in b["rows"]]

    def returned(self, g: int, out: np.ndarray, at: float) -> int:
        """Request ``g`` returned ``at`` seconds from the stream's start."""
        b, i, s, e = self.span(g)
        b["latency"][i] = at - b["arrival"][i]
        if out.shape == (e - s, self.o):
            b["out"][s:e] = out
            b["ok"][i] = True
        return int(out.shape[0])

    def submitted(self):
        """(row indices, outputs, rows a request, returned-whole mask,
        latencies) of every request submitted, in order."""
        n = self.next
        parts = []
        for k, b in enumerate(self.blocks):
            m = min(BLOCK, n - k * BLOCK)
            if m <= 0:
                break
            end = int(b["starts"][m])
            parts.append((b["idx"][:end], b["out"][:end],
                          np.diff(b["starts"][:m + 1]), b["ok"][:m],
                          b["latency"][:m]))
        return tuple(np.concatenate([p[j] for p in parts]) for j in range(5))


class Driver:
    """Set-up, warm-up, window, comparison and trace of a score cell."""

    def __init__(self, cell, seed: int, device, trace: bool):
        self.config = cell.config
        self.mix = cell.mix
        self.seed = int(seed)
        self.device = torch.device(device)
        self.trace = bool(trace)
        self.device_trace = None

    def setup(self) -> None:
        from repro_torch.core.splitnn import SplitNNConfig
        from repro_torch.serve.vfl import VFLScoringEngine
        if self.device.type == "cuda":
            from repro_torch.kernels.build import build_all
            build_all(list(self.mix["kernels"]))
        parts = make_partitions(self.config)
        self.rows = parts.test
        self.dims = parts.feature_dims
        self.mdl = ref.job_settings(self.config, self.seed)
        self.params = make_weights(self.mdl, self.dims, self.seed,
                                   self.device)
        cfg = SplitNNConfig(model=self.mdl["model"],
                            n_classes=int(self.mdl["n_classes"]),
                            bottom_dim=int(self.mdl["bottom_dim"]),
                            hidden_dim=int(self.mdl["hidden_dim"]))
        self.engine = VFLScoringEngine(
            self.params, cfg, self.dims, slots=int(self.mix["slots"]),
            max_defer=int(self.mix["max_defer"]))
        self.o = ref.n_out(self.mdl)
        # warm-up: requests of a stream of its own, run dry, untimed
        warm = Traffic(self.rows, self.mix, self.o,
                       np.random.default_rng([self.seed, 1]))
        self.engine.score_requests(
            [(g, warm.features(g)) for g in
             (warm.new() for _ in range(4 * int(self.mix["slots"])))])
        self.traffic = Traffic(self.rows, self.mix, self.o,
                               np.random.default_rng(self.seed))

    def _arrive(self) -> None:
        """Submit every request whose arrival has come."""
        now = time.perf_counter() - self.t0
        while self.next_at <= now:
            g = self.traffic.new()
            self.engine.submit(g, self.traffic.features(g))
            self.next_at = self.traffic.arrival(self.traffic.next)

    def _step(self) -> int:
        """One engine round; every request that returned is recorded.
        Returns the rows returned."""
        done = self.engine.step()
        at = time.perf_counter() - self.t0
        return sum(self.traffic.returned(g, out, at) for g, out in done)

    # ------------------------------------------------------------ window

    def window(self, seconds: float) -> None:
        from repro_torch.obs.trace import Tracer, use_tracer
        from repro_torch.kernels.build import LAUNCHES
        self.tracer = Tracer() if self.trace else None
        self.rows_done = 0
        rounds = 0
        start_at = int(self.mix["profile_after_rounds"])
        n_prof = int(self.mix["profile_rounds"])
        tries = 0
        self.next_at = self.traffic.arrival(0)
        with use_tracer(self.tracer):
            self.t0 = time.perf_counter()
            while time.perf_counter() - self.t0 < seconds:
                self._arrive()
                if not self.engine.has_work:
                    continue
                if (self.trace and self.device_trace is None
                        and rounds >= start_at
                        and tries < int(self.mix["profile_tries"])):
                    tries += 1
                    before = LAUNCHES["splitnn_bottom"]
                    with DeviceWindow(self.device) as w:
                        for _ in range(n_prof):
                            self._arrive()
                            self.rows_done += self._step()
                    made = LAUNCHES["splitnn_bottom"] - before
                    rounds += n_prof
                    if w.trace.ops and w.trace.launches(
                            bottom_kernel.SYMBOL) == made:
                        self.device_trace = w.trace
                        self.profiled_dispatches = made
                    continue
                self.rows_done += self._step()
                rounds += 1
            self.t1 = time.perf_counter()
            self.backlog_rows = self.engine.queued_rows
            deadline = time.perf_counter() + 60.0
            while self.engine.has_work and time.perf_counter() < deadline:
                self._step()
            self.drain_s = time.perf_counter() - self.t1

    @property
    def attempted(self) -> int:
        return self.traffic.next

    @property
    def failed(self) -> int:
        return int(self.attempted - self.traffic.submitted()[3].sum())

    def end_to_end(self) -> dict:
        return {"score_rows_per_s": self.rows_done / (self.t1 - self.t0)}

    def summary(self) -> dict:
        """The engine's counts over the window and the drain, for the
        run's record."""
        st = self.engine.stats
        return {"requests": st.requests, "completed": st.completed,
                "dispatches": st.dispatches,
                "mean_occupancy": st.mean_occupancy,
                "forced_splits": st.forced_splits,
                "rows_in_window": self.rows_done,
                "offered_rows": int(self.traffic.submitted()[2].sum()),
                "backlog_rows_at_close": self.backlog_rows,
                "drain_s": self.drain_s}

    def errors(self) -> List[str]:
        return []

    def layer_data(self):
        from types import SimpleNamespace
        launches = []
        if self.device_trace is not None:
            o = (int(self.mdl["bottom_dim"]) if self.mdl["model"] == "mlp"
                 else ref.n_out(self.mdl))
            launches = [(self.profiled_dispatches,
                         dict(m=len(self.dims), rows=int(self.mix["slots"]),
                              d=max(self.dims), o=o, gather=False))]
        return SimpleNamespace(
            spans=self.tracer.finished() if self.tracer else [],
            device=self.device_trace, launches=launches,
            latencies=self.traffic.submitted()[4], rows_done=self.rows_done,
            window_s=self.t1 - self.t0, model=self.mdl, dims=self.dims)

    # -------------------------------------------------------- comparison

    def judge(self, device) -> tuple:
        """``score_missing``: requests that never returned, or returned
        another number of rows; ``score_out_gap``: the largest gap of an
        output over max(1, the largest reference output)."""
        params = ref.params_numpy(self.params)
        self.engine = None
        idx, out, counts, ok, _ = self.traffic.submitted()
        keep = np.repeat(ok, counts)
        gap = 0.0
        if keep.any():
            want = ref.predict(params, self.mdl["model"],
                                  [f[idx[keep]] for f in self.rows],
                                  device=device)
            got = out[keep].astype(np.float64)
            gap = (float(np.abs(got - want).max())
                   / max(1.0, float(np.abs(want).max())))
        return ({"score_missing": float(ok.size - ok.sum()),
                 "score_out_gap": gap}, int(ok.sum()))
