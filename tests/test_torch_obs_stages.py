"""The host phases of a TreeCSS job each have a span of their own, and the
job's root span carries its thread's CPU seconds.

Tiny traced ``treecss`` jobs on the CPU through ``run_pipeline`` (HI × mlp
on the scan engine and on the loop engine, YP × linreg, 900 rows, 3
clients): every phase span sits under the parent it names, the counts
the spans record match the stage results, the coreset's sorts record
the forms the inputs' shapes imply, the host accounting is within
the span's wall time, a job's results are bitwise the same traced or not,
and an untraced job reads no thread clock.
"""
import time

import numpy as np
import pytest
import torch

from repro_torch.config import AlignOptions, EngineOptions
from repro_torch.core import coreset
from repro_torch.core.splitnn import SplitNNConfig
from repro_torch.core.treecss import run_pipeline
from repro_torch.data.synthetic import DATASETS, make_dataset
from repro_torch.data.vertical import partition_features
from repro_torch.obs import trace
from repro_torch.obs.trace import NULL_SPAN, Tracer, span, use_tracer
from repro_torch.train.optimizer import tree_leaves

N, SEED = 900, 3

#: each new span and the span it sits in
PARENTS = {
    "align.ids": "pipeline.align",
    "align.rows": "pipeline.align",
    "align.canon": "align.mpsi",
    "align.he": "align.broadcast",
    "coreset.kmeans": "coreset.fit",
    "coreset.rank": "coreset.fit",
    "coreset.groups": "coreset.select",
    "coreset.pick": "coreset.select",
    "train.copy": "train.epoch",
    "train.grads": "train.epoch",
    "train.adam": "train.epoch",
    "train.sync": "train.epoch",
}
#: the phases the loop engine has (no epoch copy, one sync a step)
LOOP_PHASES = {"train.grads", "train.adam"}

JOBS = {"mlp": ("HI", "scan"), "linreg": ("YP", "scan"),
        "mlp-loop": ("HI", "loop")}


def _partitions(name):
    x, y = make_dataset(DATASETS[name], seed=0, n_override=N)
    order = np.random.default_rng(1).permutation(N)
    n_tr = int(N * 0.7)
    return (partition_features(x[order[:n_tr]], y[order[:n_tr]], 3),
            partition_features(x[order[n_tr:]], y[order[n_tr:]], 3))


def _job(job, traced):
    data, engine = JOBS[job]
    model = job.split("-")[0]
    tr, te = _partitions(data)
    cfg = SplitNNConfig(model=model, n_classes=0 if model == "linreg" else 2,
                        lr=0.05, batch_size=64, max_epochs=3)
    return run_pipeline(
        tr, te, cfg, variant="treecss",
        clusters_per_client=12 if model == "linreg" else 14, seed=SEED,
        options=EngineOptions(device="cpu", trace=traced,
                              train_engine=engine),
        align=AlignOptions(protocol="oprf", psi_backend="device"))


@pytest.fixture(scope="module")
def jobs():
    return {job: (_job(job, True), _job(job, False)) for job in JOBS}


def _parents(rep):
    spans = rep.tracer.finished()
    by_id = {s.sid: s for s in spans}
    return spans, {s.sid: by_id[s.parent].name if s.parent >= 0 else None
                   for s in spans}


@pytest.mark.parametrize("job", list(JOBS))
def test_every_phase_span_under_its_parent(jobs, job):
    spans, parent = _parents(jobs[job][0])
    want = PARENTS if not job.endswith("loop") else {
        n: PARENTS[n] for n in PARENTS
        if not n.startswith("train.") or n in LOOP_PHASES}
    seen = {}
    for s in spans:
        if s.name in PARENTS:
            assert parent[s.sid] == PARENTS[s.name], s.name
            seen[s.name] = seen.get(s.name, 0) + 1
    assert set(seen) == set(want)
    for name in ("align.ids", "align.rows", "align.canon", "align.he",
                 "coreset.kmeans", "coreset.rank", "coreset.groups",
                 "coreset.pick"):
        assert seen[name] == 1, name


@pytest.mark.parametrize("job", list(JOBS))
def test_phase_counts_match_the_stages(jobs, job):
    rep = jobs[job][0]
    by = {}
    for s in rep.tracer.finished():
        by.setdefault(s.name, []).append(s)
    (groups,) = by["coreset.groups"]
    assert groups.attrs["n_groups"] == rep.coreset.n_groups
    (pick,) = by["coreset.pick"]
    assert pick.attrs["n_coreset"] == rep.coreset.indices.shape[0]
    assert by["align.rows"][0].attrs["rows"] == rep.mpsi.intersection.shape[0]
    assert by["align.he"][0].attrs["samples"] == min(
        64, rep.mpsi.intersection.shape[0])
    assert by["coreset.rank"][0].attrs["rows"] == (
        rep.mpsi.intersection.shape[0] * 3)
    # the sorts' forms follow from the shapes: 3 clients of k clusters,
    # 2 classes or 16 label bins, one word a row where it fits 64 bits
    n = rep.mpsi.intersection.shape[0]
    k, bins = (12, 16) if job == "linreg" else (14, 2)
    size = k ** 3 * bins
    assert groups.attrs["tier"] == (
        "dense" if size <= max(coreset._DENSE_PER_ROW * n, coreset._DENSE_MIN)
        else "code" if size < 1 << 63 else "rows")
    row_bits = coreset._F32_BITS + coreset._bits(n)
    assert by["coreset.rank"][0].attrs["packed"] == (
        3 if coreset._bits(k) + row_bits <= 64 else 0)
    assert pick.attrs["packed"] is (coreset._bits(rep.coreset.n_groups)
                                    + row_bits <= 64)
    assert len(by["train.grads"]) == len(by["train.adam"]) == rep.train.steps
    assert rep.train.steps > 0
    if not job.endswith("loop"):
        assert (len(by["train.copy"]) == len(by["train.sync"])
                == rep.train.epochs)
    # the phases lie inside their epoch: their sum is at most its wall
    inner = sum(s.duration for n in PARENTS if n.startswith("train.")
                for s in by.get(n, []))
    assert inner <= sum(s.duration for s in by["train.epoch"])


def _cpu_tick() -> float:
    """The thread clock's step, in s: its stated resolution, or the step
    it is seen to take where that is coarser."""
    t0 = time.thread_time()
    while (t1 := time.thread_time()) == t0:
        pass
    return max(time.get_clock_info("thread_time").resolution, t1 - t0)


@pytest.mark.parametrize("job", list(JOBS))
def test_job_root_span_has_host_accounting(jobs, job):
    (run,) = jobs[job][0].tracer.by_name("pipeline.run")
    assert 0.0 <= run.attrs["cpu_s"] <= run.duration + _cpu_tick()
    # no other span pays for the accounting
    assert not any("cpu_s" in s.attrs for s in jobs[job][0].tracer.finished()
                   if s.name != "pipeline.run")


@pytest.mark.parametrize("job", list(JOBS))
def test_traced_job_is_bitwise_untraced(jobs, job):
    got, plain = jobs[job]
    assert plain.tracer is None
    assert np.array_equal(got.mpsi.intersection, plain.mpsi.intersection)
    assert np.array_equal(got.coreset.indices, plain.coreset.indices)
    assert np.array_equal(got.coreset.weights, plain.coreset.weights)
    assert got.train.losses == plain.train.losses
    a = tree_leaves(got.train.params)
    b = tree_leaves(plain.train.params)
    assert len(a) == len(b) > 0
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert got.metric == plain.metric


def _no_clock():
    raise AssertionError("the host clock was read")


def test_untraced_job_reads_no_thread_clock(monkeypatch):
    monkeypatch.setattr(time, "thread_time", _no_clock)
    assert trace.active_tracer() is None
    rep = _job("linreg", False)
    assert rep.tracer is None and rep.train.steps > 0
    assert span("align.he") is NULL_SPAN
    # a span the job does not open as its root records no CPU time
    tracer = Tracer()
    with use_tracer(tracer), span("pipeline.align"):
        pass
    (s,) = tracer.finished()
    assert "cpu_s" not in s.attrs


def test_host_accounting_is_the_clock_difference(monkeypatch):
    clocks = iter([10.0, 10.25])
    monkeypatch.setattr(time, "thread_time", lambda: next(clocks))
    rep = _job("linreg", True)
    (run,) = rep.tracer.by_name("pipeline.run")
    assert run.attrs["cpu_s"] == 0.25 and run.attrs["seed"] == SEED
