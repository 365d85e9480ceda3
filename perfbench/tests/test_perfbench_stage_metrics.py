"""The per-layer metrics of a job's host phases, read from a tiny traced
run of each job cell on the CPU: every one is read, the phase timings
are positive, and the phases of a stage fit inside the stage they are
part of (the stage's own metric)."""
from __future__ import annotations

import time

import pytest

from perfbench.run import run_cell

SEED = 2 ** 31 + 4321
TIMINGS = ["align_ids_ms", "align_canon_ms", "align_he_ms",
           "coreset_kmeans_ms", "coreset_rank_ms", "coreset_groups_ms",
           "train_grads_ms", "train_adam_ms"]
#: (the phases, the stage metric they are part of)
CHAINS = [(("align_ids_ms", "align_canon_ms", "align_he_ms"), "align_ms"),
          (("coreset_kmeans_ms", "coreset_rank_ms", "coreset_groups_ms"),
           "coreset_ms"),
          (("train_grads_ms", "train_adam_ms"), "train_step_ms")]


def _cpu_tick() -> float:
    """The thread clock's step, in s: its stated resolution, or the step
    it is seen to take where that is coarser."""
    t0 = time.thread_time()
    while (t1 := time.thread_time()) == t0:
        pass
    return max(time.get_clock_info("thread_time").resolution, t1 - t0)


def _metrics(tiny, name):
    result, _ = run_cell(tiny(name), SEED, 1.0, True, device="cpu",
                         start=time.time())
    assert result["correct"], result["checks"]
    return {k: v["value"] for k, v in result["metrics"].items()}


@pytest.mark.parametrize("name", ["hi-mlp.treecss", "yp-linreg.treecss"])
def test_stage_metrics(tiny, name):
    got = _metrics(tiny, name)
    assert set(TIMINGS + ["host_offcpu_ms.job"]) <= set(got)
    assert all(got[k] > 0 for k in TIMINGS)
    # a job's wall less its thread's CPU time, to within the clock's step
    assert got["host_offcpu_ms.job"] >= -1e3 * _cpu_tick()
    for phases, stage in CHAINS:
        assert sum(got[p] for p in phases) <= got[stage], (phases, stage)


def test_self_times_add_up_to_the_job(tiny):
    from perfbench.selftime import self_times
    got = self_times(tiny("hi-mlp.treecss"), SEED, 2, "cpu")
    assert got["spans_a_job"] > 0 and got["ratio_median"] > 0
    assert all(v > -1e-6 for v in got["self_ms"].values())
    # every span's self time, summed, is the root span's wall
    assert sum(got["self_ms"].values()) == pytest.approx(
        got["span_ms"]["pipeline.run"])
    assert {"align.canon", "coreset.groups", "train.grads"} <= set(
        got["self_ms"])
