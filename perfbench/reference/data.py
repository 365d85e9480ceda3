"""The benchmark's inputs: frozen copies of the data generator, the
70/30 split with its vertical partition, and the id universe.

The paper's data sets cannot be fetched here, so a configuration names
a seeded Gaussian-mixture stand-in with the data set's signature (rows,
columns, classes; Table 1).  These are numpy copies of the generator
the system under test ships with, kept under the benchmark so that the
inputs stay what they were whatever a later change does to the
program.  The harness makes the partitions once a run and hands the
same arrays to the program and to the reference.  The program makes a
job's id lists itself from the job's seed, and the reference makes
them again here (``make_id_universe``).
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

__all__ = ["Partitions", "make_dataset", "make_partitions",
           "make_id_universe"]


@dataclasses.dataclass
class Partitions:
    """A data set split 70/30 and partitioned by columns: each client's
    (rows, d_m) slice of the train and test rows, and the labels, which
    the label owner holds."""
    train: List[np.ndarray]
    train_labels: np.ndarray
    test: List[np.ndarray]
    test_labels: np.ndarray

    @property
    def feature_dims(self) -> List[int]:
        return [int(f.shape[1]) for f in self.train]


def make_dataset(spec: dict, seed: int):
    """(X (N, d) f32, y (N,)): class-structured Gaussian mixtures with
    ``spec``'s signature (``n_instances``, ``n_features``, ``n_classes``,
    0 for regression, ``modes_per_class``, ``margin``, ``noise``)."""
    rng = np.random.default_rng(seed)
    n = int(spec["n_instances"])
    d = int(spec["n_features"])
    n_classes = int(spec["n_classes"])
    modes = int(spec["modes_per_class"])
    margin = float(spec["margin"])
    noise = float(spec["noise"])
    if n_classes == 0:
        k = modes * 4
        centers = rng.normal(0, margin, (k, d))
        assign = rng.integers(0, k, n)
        x = centers[assign] + rng.normal(0, noise, (n, d))
        w_true = rng.normal(0, 1, (d,)) * (rng.random(d) < 0.4)
        y = x @ w_true + 0.1 * rng.normal(0, 1, n)
        y = 50 + 15 * (y - y.mean()) / (y.std() + 1e-9)
        return x.astype(np.float32), y.astype(np.float32)
    k = n_classes * modes
    centers = rng.normal(0, margin, (k, d))
    mode_class = np.repeat(np.arange(n_classes), modes)
    assign = rng.integers(0, k, n)
    x = centers[assign] + rng.normal(0, noise, (n, d))
    y = mode_class[assign]
    return x.astype(np.float32), y.astype(np.int64)


def _columns(d: int, clients: int) -> List[slice]:
    """Equal column blocks, the first ``d % clients`` one wider."""
    sizes = [d // clients] * clients
    for i in range(d % clients):
        sizes[i] += 1
    out, start = [], 0
    for s in sizes:
        out.append(slice(start, start + s))
        start += s
    return out


def make_partitions(config: dict) -> Partitions:
    """The configuration's data set from its ``data_seed``, split by a
    permutation from ``data_seed + 1`` into ``train_fraction`` train rows
    and the rest, each partitioned by columns over ``clients``.  One data
    set for every run: a run's seed draws the work done on it (the jobs'
    id lists and initialisations, the requests), so that every seed asks
    for work of the same size."""
    spec = config["dataset"]
    split = config["split"]
    seed = int(config["data_seed"])
    x, y = make_dataset(spec, seed)
    n = x.shape[0]
    order = np.random.default_rng(seed + 1).permutation(n)
    n_tr = int(n * float(split["train_fraction"]))
    cols = _columns(x.shape[1], int(split["clients"]))
    tr, te = order[:n_tr], order[n_tr:]
    return Partitions(train=[np.ascontiguousarray(x[tr][:, c]) for c in cols],
                      train_labels=y[tr].copy(),
                      test=[np.ascontiguousarray(x[te][:, c]) for c in cols],
                      test_labels=y[te].copy())


def make_id_universe(n_clients: int, n_per_client: int, overlap: float,
                     seed: int):
    """Each client's shuffled id list: a common core of
    ``round(n · overlap)`` ids (paper §5.3) and ids of its own.
    Returns (id lists, sorted core)."""
    rng = np.random.default_rng(seed)
    n_core = int(round(n_per_client * overlap))
    universe = rng.permutation(int(n_per_client * n_clients * 2 + n_core))
    core = universe[:n_core]
    cursor = n_core
    sets = []
    for _ in range(n_clients):
        extra = universe[cursor:cursor + (n_per_client - n_core)]
        cursor += n_per_client - n_core
        sets.append(rng.permutation(np.concatenate([core, extra])))
    return sets, np.sort(core)
