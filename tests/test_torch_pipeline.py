"""The k-NN slice end to end: ``run_pipeline(model="knn")`` of the port
against the reference for the four Table-2 variants, on the paper's HI
spec cut to 900 rows (630 train / 270 test as
``benchmarks/common.dataset_partitions`` splits it), 3 clients, k=14,
OPRF on the device backend, the reference on its Pallas kernels.

Exact: the intersection, the MPSIStats counters, n_train, the coreset
indices and weights, the k-NN predictions and the metric."""
import numpy as np
import pytest
import torch

from repro.config import AlignOptions as JaxAlign
from repro.core.splitnn import SplitNNConfig as JaxConfig
from repro.core.splitnn import knn_predict as jax_knn_predict
from repro.core.treecss import run_pipeline as jax_run_pipeline
from repro.data.synthetic import DATASETS, make_dataset
from repro.data.vertical import partition_features
from repro_torch.config import AlignOptions, EngineOptions
from repro_torch.core.splitnn import SplitNNConfig, knn_predict
from repro_torch.core.treecss import run_pipeline
from repro_torch.data.vertical import VerticalPartition
from repro_torch.obs.trace import Tracer

torch.set_num_threads(1)
N, K, SEED = 900, 14, 0
VARIANTS = ("starall", "treeall", "starcss", "treecss")


def _hi_partitions():
    x, y = make_dataset(DATASETS["HI"], seed=SEED, n_override=N)
    order = np.random.default_rng(SEED + 1).permutation(N)
    n_tr = int(N * 0.7)
    return (partition_features(x[order[:n_tr]], y[order[:n_tr]], 3),
            partition_features(x[order[n_tr:]], y[order[n_tr:]], 3))


def _port(part):
    return VerticalPartition(part.client_features, part.labels,
                             part.feature_slices)


@pytest.fixture(scope="module")
def runs():
    tr, te = _hi_partitions()
    out = {}
    for variant in VARIANTS:
        want = jax_run_pipeline(
            tr, te, JaxConfig(model="knn", n_classes=2), variant=variant,
            clusters_per_client=K, kmeans_impl="pallas", seed=SEED,
            align=JaxAlign(protocol="oprf", psi_backend="device",
                           impl="pallas"))
        got = run_pipeline(
            _port(tr), _port(te), SplitNNConfig(model="knn", n_classes=2),
            variant=variant, clusters_per_client=K, seed=SEED,
            options=EngineOptions(device="cpu", trace=True),
            align=AlignOptions(protocol="oprf", psi_backend="device"))
        out[variant] = (got, want)
    return tr, te, out


@pytest.mark.parametrize("variant", VARIANTS)
def test_pipeline_matches_reference(runs, variant):
    _, _, out = runs
    got, want = out[variant]
    assert np.array_equal(got.mpsi.intersection, want.mpsi.intersection)
    for f in ("rounds", "total_bytes", "total_messages", "schedule",
              "device_dispatches"):
        assert getattr(got.mpsi, f) == getattr(want.mpsi, f), f
    assert got.n_train == want.n_train
    assert (got.coreset is None) == (want.coreset is None)
    if want.coreset is not None:
        assert np.array_equal(got.coreset.indices, want.coreset.indices)
        assert np.array_equal(got.coreset.weights, want.coreset.weights)
        assert got.coreset.n_groups == want.coreset.n_groups
        assert got.coreset.comm_bytes == want.coreset.comm_bytes
    assert got.metric == want.metric
    assert got.align_wall_seconds > 0 and got.train_wall_seconds > 0


@pytest.mark.parametrize("weighted", [False, True])
def test_knn_predictions_match_reference(runs, weighted):
    tr, te, out = runs
    rep = out["treecss"][1]
    train, w = tr, None
    if weighted:      # the coreset's rows and weights, as treecss votes
        from repro.core.treecss import _align
        aligned = _align(tr, "tree", seed=SEED, align=JaxAlign(
            protocol="oprf", psi_backend="device"))[0]
        train, w = aligned.take(rep.coreset.indices), rep.coreset.weights
    want = jax_knn_predict(train, te, 5, sample_weights=w)
    got = knn_predict(_port(train), _port(te), 5, sample_weights=w,
                      device="cpu")
    assert np.array_equal(got, want)


def test_emit_metrics_snapshot(runs):
    from repro_torch.obs.metrics import MetricsRegistry
    _, _, out = runs
    got = out["treecss"][0]
    reg = MetricsRegistry()
    got.emit_metrics(reg)
    snap = reg.snapshot()
    assert snap["align.total_bytes"] == got.mpsi.total_bytes
    assert snap["align.device_dispatches"] == got.mpsi.device_dispatches
    assert snap["coreset.n_coreset"] == got.n_train
    assert snap["pipeline.metric"] == got.metric
    assert snap["train.steps"] == 0


def test_pipeline_trace_has_every_stage(runs):
    _, _, out = runs
    tracer = out["treecss"][0].tracer
    assert isinstance(tracer, Tracer)
    names = {s.name for s in tracer.finished()}
    assert {"pipeline.run", "pipeline.align", "align.round",
            "align.dispatch", "pipeline.coreset", "coreset.fit",
            "pipeline.train"} <= names
