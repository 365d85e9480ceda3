"""A whole run of each cell at a tiny size on the CPU, through the
harness past its look for a card, with the program's plain versions:
the comparison accepts the program, and rejects it with the timed path
broken underneath (each fault a cell can have) and the control (the
reference in bfloat16 in the program's place)."""
from __future__ import annotations

import importlib
import time

import numpy as np
import pytest
import torch

from perfbench import control, faults
from perfbench.run import run_cell

JOB_CELLS = ["hi-mlp.treecss", "yp-linreg.treecss", "hi-mlp.starall"]
SEED = 2 ** 31 + 12345


def _run(c, trace=False, seconds=1.0):
    result, judged = run_cell(c, SEED, seconds, trace, device="cpu",
                              start=time.time())
    return result, judged


@pytest.mark.parametrize("name", JOB_CELLS + ["hi-mlp.score"])
def test_run_is_correct(tiny, name):
    c = tiny(name)
    result, judged = _run(c)
    assert judged >= 1
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["metrics"]) == {m["name"] for m in c.end_to_end}
    assert all(v["value"] > 0 for v in result["metrics"].values())
    assert result["attempted"] >= result["failed"]
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("name", ["hi-mlp.treecss", "hi-mlp.score"])
def test_traced_run_reads_spans(tiny, name):
    """On the CPU the profiler sees no device operation and there is no
    card's peak, so the device and MFU metrics are left out; the span and
    clock metrics are read."""
    c = tiny(name)
    result, _ = _run(c, trace=True)
    got = set(result["metrics"])
    span_metrics = {"align_ms", "coreset_ms", "train_step_ms",
                    "eval_ms"} if name != "hi-mlp.score" else {
                        "score_dispatch_ms", "score_p95_ms"}
    assert span_metrics <= got
    assert not any(k in m for k in ("roofline", "idle_share", "mfu")
                   for m in got)
    assert result["correct"]


def _align_altered(f):
    def mpsi(sets, **k):
        stats = f(sets, **k)
        stats.intersection = stats.intersection[:-1]
        return stats
    return mpsi


@pytest.mark.parametrize("name,fault", [
    (name, fault) for name in ("hi-mlp.treecss", "hi-mlp.starall")
    for fault in faults.FAULTS    # starall fits no k-means, selects no rows
    if not (name.endswith("starall") and fault in faults.CORESET_FAULTS)])
def test_job_faults_are_rejected(tiny, name, fault):
    with faults.planted(fault):
        result, _ = _run(tiny(name))
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("name,fault", [
    ("hi-mlp.treecss", "a fifth of the Lloyd steps"),
    ("hi-mlp.treecss", "training stopped early"),
    ("hi-mlp.starall", "training stopped early")])
def test_work_left_out_is_counted(tiny, name, fault):
    """Less work, followed faithfully by the reference from the
    program's own state, fails only ``work_mismatch``."""
    with faults.planted(fault):
        result, _ = _run(tiny(name))
    checks = result["checks"]
    assert checks["work_mismatch"]["value"] >= 1, checks
    assert all(c["value"] <= c["limit"] for k, c in checks.items()
               if k != "work_mismatch"), checks


def test_stop_rule_reading():
    from perfbench.reference.vfl import _stop_mismatch
    mdl = {"max_epochs": 10, "convergence_window": 2,
           "convergence_eps": 1e-2}
    losses = [1.0, 0.8, 0.7, 0.65, 0.645, 0.644]
    # the rule fires first at the 6th epoch: |0.65 - 0.644| < 1e-2
    assert _stop_mismatch(losses, losses, mdl) == 0
    assert _stop_mismatch(losses[:5], losses[:5], mdl) == 1
    assert _stop_mismatch(losses + [0.6439], losses + [0.6439], mdl) == 1
    assert _stop_mismatch(losses[:3], losses[:3], dict(mdl,
                                                       max_epochs=3)) == 0


@pytest.mark.parametrize("name", ["hi-mlp.treecss", "hi-mlp.starall"])
def test_alignment_fault_is_rejected(tiny, monkeypatch, name):
    """An id dropped from the intersection the MPSI returns."""
    from repro_torch.core import mpsi
    topology = "tree" if name.endswith("treecss") else "star"
    monkeypatch.setitem(mpsi.MPSI, topology,
                        _align_altered(mpsi.MPSI[topology]))
    result, _ = _run(tiny(name))
    assert not result["correct"]
    assert result["checks"]["align_wrong_ids"]["value"] >= 1


def _dispatch_half(f):
    def dispatch(self):
        occ = [s for s in range(self.slots) if self._slot_req[s] is not None]
        keep = self._xbuf.copy()
        self._xbuf[:, len(occ) // 2:] = 0.0
        try:
            return f(self)
        finally:
            self._xbuf[:] = keep
    return dispatch


def _answer_altered(f):
    def dispatch(self):
        done = f(self)
        return [(rid, out + (1.0 if rid == 3 else 0.0)) for rid, out in done]
    return dispatch


@pytest.mark.parametrize("wrap", [_dispatch_half, _answer_altered],
                         ids=["half the slots scored", "an answer altered"])
def test_score_faults_are_rejected(tiny, monkeypatch, wrap):
    from repro_torch.serve.vfl import VFLScoringEngine
    monkeypatch.setattr(VFLScoringEngine, "dispatch",
                        wrap(VFLScoringEngine.dispatch))
    result, _ = _run(tiny("hi-mlp.score"))
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("name", JOB_CELLS + ["hi-mlp.score"])
def test_control_is_rejected(tiny, name):
    c = tiny(name)
    nums = control.control_numbers(c, SEED, torch.device("cpu"),
                                   requests=2000)
    assert control.rejected(nums, c.limits), nums


def test_job_seeds_differ_and_repeat():
    from perfbench.drivers.job import check_jobs, job_seed
    seeds = [job_seed(SEED, j) for j in range(50)]
    assert len(set(seeds)) == 50
    assert seeds == [job_seed(SEED, j) for j in range(50)]
    mix = {"check_jobs": 2, "check_pool": 4}
    got = check_jobs(SEED, mix)
    assert 1 in got and len(got) == 2 and got <= {1, 2, 3, 4}


def test_same_seed_same_inputs(tiny):
    from perfbench.reference.data import make_partitions
    c = tiny("hi-mlp.treecss")
    a, b = make_partitions(c.config), make_partitions(c.config)
    assert all(np.array_equal(x, y) for x, y in zip(a.train, b.train))
    assert np.array_equal(a.test_labels, b.test_labels)


def test_sweep_reads_sustained_and_overloaded(tiny):
    """With the harness's one host thread (an idle pool of them wakes
    tens of ms late on a shared host), a low rate is kept up with and a
    rate far over capacity leaves a backlog."""
    from perfbench.harness.env import THREADS
    from perfbench.sweep import sweep
    threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    try:
        rows = list(sweep(tiny("hi-mlp.score"), SEED, 0.5, [500, 10 ** 6],
                          torch.device("cpu")))
    finally:
        torch.set_num_threads(threads)
    low, high = rows
    assert low["returned_whole"] and high["returned_whole"]
    assert low["backlog_rows_at_close"] == 0
    assert high["backlog_rows_at_close"] > 0
    assert high["score_rows_per_s"] < high["submitted_rows_per_s"]


@pytest.mark.parametrize("fault", [None, "half of each batch left out"])
def test_program_readings(tiny, fault):
    """``control.py --program`` / ``--fault``: the numbers of the
    program's own jobs pass their limits, and fail them with a fault."""
    c = tiny("hi-mlp.treecss")
    (seed, nums), = control.program_numbers(c, [SEED], torch.device("cpu"),
                                            fault)
    assert seed == SEED
    assert control.rejected(nums, c.limits) == (fault is not None), nums
