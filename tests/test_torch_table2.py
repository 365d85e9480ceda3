"""The paper's Table-2 jobs on BA, MU, RI and BP through the port's
``run_pipeline`` against the reference's, and the engine counters
against the live reference.

(a) The eight jobs of ``data.table2.JOBS`` on those datasets × the four
variants at n = 600 (420 train / 180 test rows, 3 clients: 4/4/3 columns,
MU 8/7/7), Table-2's lr and k, batches of 64 rows and ``max_epochs=5``
(the convergence window needs more epoch losses, so the schedule alone
decides the counters).  The reference runs on its Pallas kernels in
interpret mode (``kmeans_impl="pallas"``, ``bottom_impl="pallas"``, OPRF
on the device backend with ``impl="pallas"``), the port on its plain
versions.  Bitwise: the partitions (``data.table2.dataset_partitions``
against ``benchmarks/common.dataset_partitions``), the intersection, the
``MPSIStats`` counters, n_train, the coreset's indices, weights,
``n_groups`` and ``comm_bytes``, the training counters (epochs, steps,
comm_bytes) and RI × k-NN's predictions.  The trained weights differ in
f32 ulps (ROADMAP.md R2): the last epoch loss within rtol 1e-4, the
accuracy within one test row.

(b) The counters of ``benchmarks/check_contract.row_counters`` at
``run_e2e(smoke=True)``'s settings: BA × {lr, mlp} × {none, int8, fp8}
× the four variants at n = 500, batches of ``max(8, n_train // 100)``,
15 epochs, k = 12, OPRF on the host backend, each package on its
default implementations.  The port's n_train, steps, dispatches, host
syncs and comm_bytes an epoch and ``gather_payload_bytes`` equal the
live reference's (not the committed ``engine_contract.json``, whose CSS
rows differ from the live reference on this toolchain: ROADMAP.md R14);
one dispatch and one host sync an epoch; a quantized payload at most
0.3× its f32 twin's.
"""
import functools

import numpy as np
import pytest
import torch

from benchmarks.common import dataset_partitions as jax_partitions
from repro.config import AlignOptions as JaxAlign
from repro.config import EngineOptions as JaxEngine
from repro.core.splitnn import SplitNNConfig as JaxConfig
from repro.core.splitnn import knn_predict as jax_knn_predict
from repro.core.treecss import run_pipeline as jax_run_pipeline
from repro.obs import MetricsRegistry as JaxRegistry
from repro_torch.config import AlignOptions, EngineOptions
from repro_torch.core.splitnn import SplitNNConfig, knn_predict
from repro_torch.core.treecss import _align, run_pipeline
from repro_torch.data.table2 import (JOBS, VARIANTS, dataset_partitions,
                                     table2_config)
from repro_torch.obs.metrics import MetricsRegistry

torch.set_num_threads(1)
SEED = 0
N_JOBS, N_COUNTERS = 600, 500
PAPER_JOBS = [j for j in JOBS if j[0] in ("BA", "MU", "RI", "BP")]
MAX_PAYLOAD_RATIO = 0.3


def _jax_part(part):
    from repro.data.vertical import VerticalPartition
    return VerticalPartition(part.client_features, part.labels,
                             part.feature_slices)


@functools.lru_cache(maxsize=None)
def _partitions(name, n):
    """The port's partitions, held bitwise to the reference's."""
    tr, te = dataset_partitions(name, n_override=n)
    for got, want in zip((tr, te), jax_partitions(name, n_override=n)):
        assert got.feature_slices == want.feature_slices
        for a, b in zip(got.client_features, want.client_features):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        assert got.labels.tobytes() == want.labels.tobytes()
    return tr, te


def _same_alignment(got, want):
    assert np.array_equal(got.mpsi.intersection, want.mpsi.intersection)
    for f in ("rounds", "total_bytes", "total_messages", "schedule",
              "device_dispatches"):
        assert getattr(got.mpsi, f) == getattr(want.mpsi, f), f
    assert got.n_train == want.n_train
    assert (got.coreset is None) == (want.coreset is None)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("job", PAPER_JOBS, ids=lambda j: f"{j[0]}-{j[1]}")
def test_table2_job_matches_reference(job, variant):
    ds, model, n_classes, lr, k = job
    tr, te = _partitions(ds, N_JOBS)
    kw = dict(model=model, n_classes=n_classes, lr=lr or 0.01,
              batch_size=64, max_epochs=5, seed=SEED)
    want = jax_run_pipeline(
        _jax_part(tr), _jax_part(te), JaxConfig(**kw), variant=variant,
        clusters_per_client=k, kmeans_impl="pallas", seed=SEED,
        options=JaxEngine(bottom_impl="pallas"),
        align=JaxAlign(protocol="oprf", psi_backend="device",
                       impl="pallas"))
    got = run_pipeline(
        tr, te, SplitNNConfig(**kw), variant=variant, clusters_per_client=k,
        seed=SEED, options=EngineOptions(device="cpu"),
        align=AlignOptions(protocol="oprf", psi_backend="device"))
    _same_alignment(got, want)
    if want.coreset is not None:
        assert np.array_equal(got.coreset.indices, want.coreset.indices)
        assert np.array_equal(got.coreset.weights, want.coreset.weights)
        assert got.coreset.n_groups == want.coreset.n_groups
        assert got.coreset.comm_bytes == want.coreset.comm_bytes
    for f in ("epochs", "steps", "comm_bytes"):
        assert getattr(got.train, f) == getattr(want.train, f), f
    if model == "knn":
        assert got.train.epochs == 0
        # the vote on the rows and weights the pipeline voted with
        aligned = _align(tr, "tree" if variant.startswith("tree") else
                         "star", seed=SEED, align=AlignOptions(
                             protocol="oprf", psi_backend="device",
                             device="cpu"))[0]
        train, w = aligned, None
        if got.coreset is not None:
            train, w = aligned.take(got.coreset.indices), got.coreset.weights
        pred = knn_predict(train, te, 5, sample_weights=w, device="cpu")
        assert np.array_equal(pred, jax_knn_predict(
            _jax_part(train), _jax_part(te), 5, sample_weights=w))
        assert got.metric == want.metric == float(np.mean(pred == te.labels))
        return
    assert got.train.epochs == 5
    np.testing.assert_allclose(got.train.losses[-1], want.train.losses[-1],
                               rtol=1e-4)
    assert abs(got.metric - want.metric) <= 1 / te.n_samples + 1e-12
    assert 1 / n_classes < got.metric <= 1


def _ratio(total, epochs):
    return total / epochs if epochs else 0.0


def _counters(snap):
    """``benchmarks/check_contract.row_counters`` of a metrics snapshot."""
    epochs = int(snap["train.epochs"])
    return {
        "n_train": int(snap["pipeline.n_train"]),
        "steps_per_epoch": _ratio(int(snap["train.steps"]), epochs),
        "dispatches_per_epoch": _ratio(int(snap["train.dispatches"]), epochs),
        "host_syncs_per_epoch": _ratio(int(snap["train.host_syncs"]), epochs),
        "comm_bytes_per_epoch": _ratio(int(snap["train.comm_bytes"]), epochs),
        "gather_payload_bytes": int(snap["train.gather_payload_bytes"]),
    }


@functools.lru_cache(maxsize=None)
def _port_counters(model, variant, quant):
    tr, te = _partitions("BA", N_COUNTERS)
    rep = run_pipeline(
        tr, te, table2_config(model, 2, dict(lr=0.05, mlp=0.01)[model],
                              tr.n_samples, 15),
        variant=variant, clusters_per_client=12, seed=SEED,
        options=EngineOptions(device="cpu", quant=quant),
        align=AlignOptions(protocol="oprf"))
    reg = MetricsRegistry()
    rep.emit_metrics(reg)
    return _counters(reg.snapshot()), rep.train.epochs


def _reference_counters(model, variant, quant):
    """``run_e2e(smoke=True)``'s run of one row, on the live reference."""
    tr, te = jax_partitions("BA", n_override=N_COUNTERS)
    cfg = JaxConfig(model=model, n_classes=2, lr=dict(lr=0.05, mlp=0.01)[
        model], batch_size=max(8, tr.n_samples // 100), max_epochs=15)
    rep = jax_run_pipeline(tr, te, cfg, variant=variant,
                           clusters_per_client=12, seed=SEED,
                           options=JaxEngine(bottom_impl="ref", quant=quant),
                           align=JaxAlign(protocol="oprf"))
    reg = JaxRegistry()
    rep.emit_metrics(reg)
    return _counters(reg.snapshot())


@pytest.mark.parametrize("quant", [None, "int8", "fp8"])
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("model", ["lr", "mlp"])
def test_engine_counters_match_live_reference(model, variant, quant):
    got, epochs = _port_counters(model, variant, quant)
    assert got == _reference_counters(model, variant, quant)
    assert epochs > 0
    assert got["dispatches_per_epoch"] == got["host_syncs_per_epoch"] == 1
    if quant is not None:
        f32 = _port_counters(model, variant, None)[0]
        assert got["n_train"] == f32["n_train"]
        assert (got["gather_payload_bytes"]
                <= MAX_PAYLOAD_RATIO * f32["gather_payload_bytes"])
