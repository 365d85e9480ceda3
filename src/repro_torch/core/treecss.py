"""TreeCSS end-to-end pipeline (Fig. 1): the port of
``repro.core.treecss`` for the k-NN jobs of Table 2.

The four framework variants are combinations of
  MPSI topology ∈ {star, tree(ours), path}  ×  data ∈ {ALL, CSS(ours)}:

  STARALL  = Star-MPSI + full-data model        (vanilla VFL baseline)
  TREEALL  = Tree-MPSI + full-data model
  STARCSS  = Star-MPSI + Cluster-Coreset
  TREECSS  = Tree-MPSI + Cluster-Coreset (the paper's framework)

With ``model="knn"`` nothing is trained: the pipeline aligns, builds the
coreset and predicts with the (coreset-weighted) k-NN vote.  The SplitNN
models (lr/mlp/linreg) come with the training slice (ROADMAP.md, queue
1) and raise ``NotImplementedError`` here.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch.config import AlignOptions, EngineOptions, resolve_device
from repro_torch.core.coreset import CoresetResult, cluster_coreset
from repro_torch.core.mpsi import MPSI, MPSIStats
from repro_torch.core.splitnn import SplitNNConfig, TrainReport, knn_predict
from repro_torch.data.synthetic import make_id_universe
from repro_torch.data.vertical import VerticalPartition
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import Tracer, now, span, use_tracer


@dataclasses.dataclass
class PipelineReport:
    variant: str
    mpsi: MPSIStats
    coreset: Optional[CoresetResult]
    train: TrainReport
    metric: float                  # accuracy (cls) or MSE (reg)
    align_seconds: float           # simulated protocol makespan
    coreset_seconds: float
    train_seconds: float
    n_train: int
    align_wall_seconds: float = 0.0   # measured alignment wall time
    # measured stage wall times, all read from the one obs span clock
    coreset_wall_seconds: float = 0.0
    train_wall_seconds: float = 0.0
    tracer: Optional[Tracer] = dataclasses.field(default=None, repr=False)

    @property
    def total_seconds(self) -> float:
        return self.align_seconds + self.coreset_seconds + self.train_seconds

    def emit_metrics(self, registry: MetricsRegistry) -> None:
        """Emit every stage's numbers into ``registry``.  Namespaces:
        ``align.*`` (MPSIStats), ``train.*``, ``coreset.*``,
        ``pipeline.*`` (stage wall/simulated times, metric, n_train)."""
        self.mpsi.emit(registry, "align.")
        registry.counter("train.epochs").inc(self.train.epochs)
        registry.counter("train.steps").inc(self.train.steps)
        registry.counter("train.comm_bytes").inc(self.train.comm_bytes)
        registry.gauge("train.train_seconds").set(self.train.train_seconds)
        registry.gauge("train.simulated_comm_seconds").set(
            self.train.simulated_comm_seconds)
        if self.coreset is not None:
            registry.counter("coreset.n_coreset").inc(
                int(self.coreset.indices.shape[0]))
            registry.counter("coreset.n_groups").inc(self.coreset.n_groups)
            registry.counter("coreset.comm_bytes").inc(
                self.coreset.comm_bytes)
        registry.gauge("pipeline.metric").set(self.metric)
        registry.counter("pipeline.n_train").inc(self.n_train)
        registry.gauge("pipeline.align_seconds").set(self.align_seconds)
        registry.gauge("pipeline.coreset_seconds").set(self.coreset_seconds)
        registry.gauge("pipeline.train_seconds").set(self.train_seconds)
        registry.gauge("pipeline.align_wall_seconds").set(
            self.align_wall_seconds)
        registry.gauge("pipeline.coreset_wall_seconds").set(
            self.coreset_wall_seconds)
        registry.gauge("pipeline.train_wall_seconds").set(
            self.train_wall_seconds)


def _align(partition: VerticalPartition, topology: str, *,
           align: AlignOptions, seed: int
           ) -> Tuple[VerticalPartition, MPSIStats, float, float]:
    """Run MPSI over per-client ID sets and restrict data to the aligned
    set: row i of the partition carries id ``sets[0][i]`` (the label
    owner's shuffled ordering), and the aligned partition is exactly the
    rows whose ids the intersection returned, in ascending row order.

    Returns (aligned, stats, simulated_seconds, wall_seconds)."""
    n = partition.n_samples
    m = partition.n_clients
    sets, _core = make_id_universe(m, n, align.overlap, seed=seed)
    sp = span("align.mpsi", topology=topology, protocol=align.protocol,
              backend=align.psi_backend, n_clients=m, n_ids=n)
    t0 = now()
    with sp:
        stats = MPSI[topology](sets, options=align)
    align_wall = now() - t0
    sp.set(comm_bytes=stats.total_bytes, rounds=stats.rounds,
           n_align=int(stats.intersection.shape[0]))
    inter = stats.intersection
    # id -> row: invert the label owner's id list (ids are unique, and
    # inter ⊆ sets[0] because it intersects every client's set)
    row_ids = np.asarray(sets[0], np.int64)
    order = np.argsort(row_ids)
    pos = np.searchsorted(row_ids, inter, sorter=order)
    rows = np.sort(order[pos])
    return partition.take(rows), stats, stats.simulated_seconds, align_wall


def run_pipeline(train_part: VerticalPartition,
                 test_part: VerticalPartition,
                 cfg: SplitNNConfig, *,
                 variant: str = "treecss",
                 clusters_per_client: int = 12,
                 use_weights: bool = True,
                 kmeans_impl: Optional[str] = None,
                 seed: int = 0,
                 knn_k: int = 5,
                 options: Optional[EngineOptions] = None,
                 align: Optional[AlignOptions] = None) -> PipelineReport:
    """Align → (coreset) → k-NN vote, stage by stage.

    ``options.device`` places every device stage (default CUDA);
    ``align`` inherits it unless it names its own.  ``kmeans_impl`` and
    ``align.impl`` pick the kernels ("kernel") or their plain versions
    ("ref"); ``None`` means the kernels on CUDA and the plain versions on
    the CPU.  ``options.trace`` turns on the obs layer (a ``Tracer``, or
    any truthy value to self-create one; it comes back on the report).
    """
    options = options or EngineOptions()
    align = (align or AlignOptions()).with_engine_defaults(options)
    device = resolve_device(options.device)
    if cfg.model != "knn":
        raise NotImplementedError(
            f"model={cfg.model!r}: the SplitNN models come with the "
            "training slice of the port (ROADMAP.md, queue 1); this slice "
            "runs model='knn'")
    variant = variant.lower()
    topology = "tree" if variant.startswith("tree") else (
        "path" if variant.startswith("path") else "star")
    use_css = variant.endswith("css")
    trace = options.trace
    tracer = trace if isinstance(trace, Tracer) else (
        Tracer() if trace else None)

    with use_tracer(tracer), span("pipeline.run", variant=variant,
                                  model=cfg.model, seed=seed):
        with span("pipeline.align", topology=topology,
                  protocol=align.protocol, backend=align.psi_backend):
            aligned, mpsi_stats, align_secs, align_wall = _align(
                train_part, topology, align=align, seed=seed)

        coreset_res = None
        weights = None
        coreset_wall = 0.0
        if use_css:
            cs_sp = span("pipeline.coreset", k=clusters_per_client,
                         rows=aligned.n_samples)
            t0 = now()
            with cs_sp:
                coreset_res = cluster_coreset(
                    aligned, clusters_per_client, seed=seed,
                    kmeans_impl=kmeans_impl, device=device)
            coreset_wall = now() - t0
            cs_sp.set(n_coreset=int(coreset_res.indices.shape[0]),
                      comm_bytes=coreset_res.comm_bytes)
            train_data = aligned.take(coreset_res.indices)
            if use_weights:
                weights = coreset_res.weights
            # steps 1-2 run concurrently on the clients: stage cost is the
            # per-client makespan + label-owner selection (+ HE)
            coreset_secs = coreset_res.makespan_seconds
        else:
            train_data = aligned
            coreset_secs = 0.0

        t0 = now()
        with span("pipeline.train", model="knn", rows=train_data.n_samples):
            pred = knn_predict(train_data, test_part, knn_k,
                               sample_weights=weights, device=device)
        train_secs = now() - t0
        metric = float(np.mean(pred == test_part.labels))
        train_report = TrainReport(losses=[], epochs=0, steps=0,
                                   train_seconds=train_secs, comm_bytes=0,
                                   simulated_comm_seconds=0.0, params=None)

    return PipelineReport(
        variant=variant, mpsi=mpsi_stats, coreset=coreset_res,
        train=train_report, metric=metric, align_seconds=align_secs,
        coreset_seconds=coreset_secs, train_seconds=train_secs,
        n_train=train_data.n_samples, align_wall_seconds=align_wall,
        coreset_wall_seconds=coreset_wall, train_wall_seconds=train_secs,
        tracer=tracer)
