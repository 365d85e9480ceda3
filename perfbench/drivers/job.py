"""Whole TreeCSS jobs back to back: the ``job`` driver.

A job is what a VFL consortium runs for each new id list: the clients'
id lists are aligned (MPSI), the aligned rows shrink to a coreset
(Cluster-Coreset, ``treecss``) or stay whole (``starall``), a SplitNN
trains on them, and it is evaluated on the test split.  The program's
entry is ``repro_torch.core.treecss.run_pipeline``.

The data set is the configuration's own (``data_seed``), the same in
every run; job ``j`` takes its own seed from (``--seed``, ``j``), which
draws the id universe, the k-means initialisation, the SplitNN's
initialisation and its batch order, so no job repeats another's work.
Job 0 is the untimed warm-up.

For the jobs the comparison samples (``check_jobs``: the window's
first, and more drawn from the seed among its first ``check_pool``) the
driver keeps what the
program produced on its way: the k-means++ centroids, every Lloyd
step's centroids and assignment, and the evaluation's raw outputs, by
wrapping those three functions of the program for the length of the job
(the wrappers only hold references to what the functions return).
"""
from __future__ import annotations

import dataclasses
import importlib
import time
from types import SimpleNamespace
from typing import List, Optional

import numpy as np
import torch

from perfbench.harness.profile import DeviceWindow
from perfbench.reference import vfl as ref
from perfbench.reference.data import make_partitions
from perfbench.rooflines import bottom_kernel

#: the untimed warm-up's job index; the window's jobs are 1, 2, ...
WARMUP_JOB = 0


def job_seed(seed: int, j: int) -> int:
    """Job ``j``'s seed: a word of a SeedSequence over (run seed, j)."""
    return int(np.random.SeedSequence([int(seed), int(j)])
               .generate_state(1, np.uint32)[0])


def check_jobs(seed: int, mix: dict) -> set:
    """The window's jobs the comparison reads: the first, and
    ``check_jobs - 1`` more drawn from the seed among jobs 2 to
    ``check_pool``."""
    rng = np.random.default_rng(int(seed))
    more = rng.choice(np.arange(2, int(mix["check_pool"]) + 1),
                      int(mix["check_jobs"]) - 1, replace=False)
    return {1, *(int(j) for j in more)}


class _Capture:
    """Holds what three functions of the program return during one job:
    k-means++'s centroids, each Lloyd step's (centroids, assignment),
    ``score_partition``'s raw outputs."""

    def __init__(self):
        self.init = None
        self.steps: list = []
        self.eval_out = None

    @staticmethod
    def _modules():
        # by module path: the package ``repro_torch.core`` exports a
        # function named ``kmeans`` over its module of that name
        return (importlib.import_module("repro_torch.core.kmeans"),
                importlib.import_module("repro_torch.serve.vfl"))

    def __enter__(self):
        km, sv = self._modules()
        self._saved = (km.kmeans_pp_init, km.lloyd_step, sv.score_partition)
        pp, step, score = self._saved

        def kmeans_pp_init(*a, **k):
            self.init = pp(*a, **k)
            return self.init

        def lloyd_step(*a, **k):
            out = step(*a, **k)
            self.steps.append(out)
            return out

        def score_partition(*a, **k):
            self.eval_out = score(*a, **k)
            return self.eval_out

        km.kmeans_pp_init, km.lloyd_step = kmeans_pp_init, lloyd_step
        sv.score_partition = score_partition
        return self

    def __exit__(self, *exc):
        km, sv = self._modules()
        km.kmeans_pp_init, km.lloyd_step, sv.score_partition = self._saved


@dataclasses.dataclass
class JobRun:
    """One job of the window: its counts and stage walls (``info``), and
    the program's whole report only where the comparison reads it."""
    seed: int
    t0: float
    t1: float
    info: object = None
    report: object = None
    capture: Optional[_Capture] = None
    profiled: bool = False
    error: Optional[str] = None


class Driver:
    """Set-up, warm-up, window, comparison and trace of a job cell."""

    def __init__(self, cell, seed: int, device, trace: bool):
        self.config = cell.config
        self.mix = cell.mix
        self.seed = int(seed)
        self.device = torch.device(device)
        self.trace = bool(trace)
        self.variant = self.mix["variant"]
        self.jobs: List[JobRun] = []
        self.device_trace = None
        self.profile_tries = 0
        self.check = check_jobs(self.seed, self.mix)

    # -------------------------------------------------------- set-up

    def setup(self) -> None:
        from repro_torch.data.vertical import VerticalPartition
        if self.device.type == "cuda":
            from repro_torch.kernels.build import build_all
            build_all(list(self.mix["kernels"]))
        self.parts = make_partitions(self.config)
        dims = self.parts.feature_dims
        starts = np.cumsum([0] + dims)
        slices = [slice(int(a), int(b)) for a, b in zip(starts, starts[1:])]
        self.train = VerticalPartition(self.parts.train,
                                       self.parts.train_labels, slices)
        self.test = VerticalPartition(self.parts.test,
                                      self.parts.test_labels, slices)
        warm = self._run(WARMUP_JOB)
        if warm.error:
            raise RuntimeError("the warm-up job failed:\n" + warm.error)

    def _settings(self, seed: int):
        from repro_torch.core.splitnn import SplitNNConfig
        mdl = ref.job_settings(self.config, seed)
        return SplitNNConfig(
            model=mdl["model"], n_classes=int(mdl["n_classes"]),
            bottom_dim=int(mdl["bottom_dim"]),
            hidden_dim=int(mdl["hidden_dim"]), lr=float(mdl["lr"]),
            batch_size=int(mdl["batch_size"]),
            max_epochs=int(mdl["max_epochs"]),
            convergence_eps=float(mdl["convergence_eps"]),
            convergence_window=int(mdl["convergence_window"]),
            seed=int(mdl["seed"]))

    def _run(self, j: int, capture: bool = False) -> JobRun:
        """Job ``j`` through the program, ending synchronised (the
        evaluation copies its outputs to the host)."""
        from repro_torch.config import AlignOptions, EngineOptions
        from repro_torch.core.treecss import run_pipeline
        from repro_torch.obs.trace import Tracer
        seed = job_seed(self.seed, j)
        al = self.config["align"]
        cs = self.config["coreset"]
        run = JobRun(seed=seed, t0=time.perf_counter(), t1=0.0)
        cap = _Capture() if capture else None
        if cap is not None:
            cap.__enter__()
        try:
            run.report = run_pipeline(
                self.train, self.test, self._settings(seed),
                variant=self.variant,
                clusters_per_client=int(cs["clusters_per_client"]),
                use_weights=bool(cs["use_weights"]), seed=seed,
                options=EngineOptions(
                    device=self.device,
                    block_b=int(self.config["eval"]["block_b"]),
                    trace=Tracer() if self.trace else None),
                align=AlignOptions(protocol=al["protocol"],
                                   psi_backend=al["psi_backend"],
                                   overlap=float(al["overlap"])))
        except Exception:   # a failed job is counted, the window goes on
            import traceback
            run.error = traceback.format_exc()
        finally:
            if cap is not None:
                cap.__exit__(None, None, None)
        run.t1 = time.perf_counter()
        run.capture = cap
        rep = run.report
        if rep is not None:
            run.info = SimpleNamespace(
                spans=rep.tracer.finished() if rep.tracer else [],
                steps=rep.train.steps, epochs=rep.train.epochs,
                n_train=rep.n_train,
                padded_batch=(rep.train.engine_stats.padded_batch
                              if rep.train.engine_stats else 0),
                align_s=rep.align_wall_seconds,
                coreset_s=rep.coreset_wall_seconds,
                train_s=rep.train_wall_seconds)
            if cap is None:
                run.report = None
        return run

    # -------------------------------------------------------- window

    def _bottom_launches(self) -> int:
        from repro_torch.kernels.build import LAUNCHES
        return LAUNCHES["splitnn_bottom"] + LAUNCHES["splitnn_bottom_gather"]

    def window(self, seconds: float) -> None:
        """Jobs back to back until ``seconds`` have passed; the last job
        started inside them runs to its end.  With tracing, the first
        jobs are profiled, one at a time, until a profile holds every
        bottom-kernel launch its job made (``profile_tries`` at most)."""
        self.t0 = time.perf_counter()
        j = 1
        while time.perf_counter() - self.t0 < seconds:
            if (self.trace and self.device_trace is None
                    and self.profile_tries < int(self.mix["profile_tries"])):
                self.jobs.append(self._profiled(j))
            else:
                self.jobs.append(self._run(j, capture=j in self.check))
            j += 1
        self.t1 = time.perf_counter()

    def _profiled(self, j: int) -> JobRun:
        self.profile_tries += 1
        before = self._bottom_launches()
        with DeviceWindow(self.device) as w:
            run = self._run(j, capture=j in self.check)
        run.profiled = True
        made = self._bottom_launches() - before
        if (run.error is None and w.trace.ops
                and w.trace.launches(bottom_kernel.SYMBOL) == made):
            self.device_trace = w.trace
            self.profiled_job = run
        return run

    # ---------------------------------------------------- end to end

    @property
    def attempted(self) -> int:
        return len(self.jobs)

    @property
    def failed(self) -> int:
        return sum(r.error is not None for r in self.jobs)

    def end_to_end(self) -> dict:
        return {"job_s": (self.t1 - self.t0) / max(len(self.jobs), 1)}

    def summary(self) -> dict:
        """Per-job quartiles of what the window's jobs did and took (the
        stage walls the program measures itself), for the run's record."""
        done = [r for r in self.jobs if r.info is not None]
        q = lambda v: [float(x) for x in np.percentile(v, [25, 50, 75])]
        return {"jobs": len(done), "wall_s": q([r.t1 - r.t0 for r in done]),
                "align_s": q([r.info.align_s for r in done]),
                "coreset_s": q([r.info.coreset_s for r in done]),
                "train_s": q([r.info.train_s for r in done]),
                "steps": q([r.info.steps for r in done]),
                "n_train": q([r.info.n_train for r in done])} if done else {}

    def errors(self) -> List[str]:
        return [r.error for r in self.jobs if r.error]

    # ----------------------------------------------------- per layer

    def layer_data(self):
        """What the per-layer readers read: every finished job's spans
        and counts (``profiled`` marks the job under the profiler), the
        device trace with the bottom-kernel launches it should hold."""
        jobs = [SimpleNamespace(**vars(r.info), profiled=r.profiled)
                for r in self.jobs if r.info is not None]
        traced = self.device_trace is not None
        return SimpleNamespace(
            jobs=jobs, device=self.device_trace,
            spans=self.profiled_job.info.spans if traced else [],
            launches=(self._expected_launches(self.profiled_job.info)
                      if traced else []),
            model=ref.job_settings(self.config, 0),
            dims=self.parts.feature_dims)

    def _expected_launches(self, info) -> List[tuple]:
        """(count, roofline keywords) of the bottom kernel's launches in
        one job: K2 in every training step over the padded batch, K1 in
        every evaluation block."""
        m = len(self.parts.feature_dims)
        d = max(self.parts.feature_dims)
        mdl = ref.job_settings(self.config, 0)
        o = (int(mdl["bottom_dim"]) if mdl["model"] == "mlp"
             else ref.n_out(mdl))
        n_test = self.parts.test[0].shape[0]
        bs = min(int(self.config["eval"]["block_b"]), n_test)
        return [(info.steps, dict(m=m, rows=info.padded_batch, d=d, o=o,
                                  gather=True)),
                (-(-n_test // bs), dict(m=m, rows=bs, d=d, o=o,
                                        gather=False))]

    # ---------------------------------------------------- comparison

    def records(self) -> List[dict]:
        """The sampled jobs' records, as ``reference.vfl.judge_job``
        reads them."""
        return [self._record(r) for r in self.jobs
                if r.capture is not None and r.error is None]

    def _record(self, r: JobRun) -> dict:
        rep, cap = r.report, r.capture
        rec = {"job_seed": r.seed,
               "intersection": np.asarray(rep.mpsi.intersection),
               "kmeans": None, "coreset": None,
               "losses": list(rep.train.losses),
               "params": ref.params_numpy(rep.train.params),
               "eval_out": np.asarray(cap.eval_out)}
        if rep.coreset is not None:
            dims = self.parts.feature_dims
            ns = [int(lc.assign.shape[0]) for lc in rep.coreset.local]
            init = cap.init.float().cpu().numpy()
            steps = [(c.float().cpu().numpy(), a.cpu().numpy())
                     for c, a in cap.steps]
            rec["kmeans"] = {
                "init": [init[i, :, :d] for i, d in enumerate(dims)],
                "steps": [[(c[i, :, :d], a[i, :ns[i]])
                           for i, d in enumerate(dims)] for c, a in steps],
                "final": [(lc.centroids.float().cpu().numpy(), lc.assign,
                           lc.sq_dist) for lc in rep.coreset.local]}
            rec["coreset"] = (rep.coreset.indices, rep.coreset.weights)
        return rec

    def judge(self, device) -> tuple:
        """(numbers, jobs judged): each number's worst over the sampled
        jobs."""
        worst: dict = {}
        recs = self.records()
        for rec in recs:
            got = ref.judge_job(rec, self.parts, self.config, self.variant,
                                device=device)
            for k, v in got.items():
                worst[k] = max(worst.get(k, 0.0), v)
        return worst, len(recs)
