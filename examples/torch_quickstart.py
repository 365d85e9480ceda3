"""Quickstart on the PyTorch port: TreeCSS end-to-end on a synthetic
BA-shaped dataset (``examples/quickstart.py`` on ``repro_torch``).

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

Runs all four framework variants of Table 2 (STARALL / TREEALL / STARCSS /
TREECSS) on a 3-client vertical partition and prints per-stage timings,
coreset sizes, and test accuracy.  Every device stage runs on
``--device`` (default: the CUDA card).
"""
import argparse

import numpy as np

from repro_torch.config import AlignOptions, EngineOptions
from repro_torch.core import SplitNNConfig, run_pipeline
from repro_torch.data.synthetic import DatasetSpec, make_dataset
from repro_torch.data.vertical import partition_features


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    spec = DatasetSpec("quickstart", 3000, 12, 2)
    x, y = make_dataset(spec, seed=0)
    rng = np.random.default_rng(1)
    order = rng.permutation(len(y))
    n_tr = int(len(y) * 0.7)
    train = partition_features(x[order[:n_tr]], y[order[:n_tr]], 3)
    test = partition_features(x[order[n_tr:]], y[order[n_tr:]], 3)

    cfg = SplitNNConfig(model="lr", n_classes=2, lr=0.05, batch_size=64,
                        max_epochs=60)
    print(f"{'variant':9s} {'acc':>6s} {'n_train':>8s} {'align_s':>8s} "
          f"{'coreset_s':>9s} {'train_s':>8s} {'total_s':>8s}")
    for variant in ("starall", "treeall", "starcss", "treecss"):
        rep = run_pipeline(train, test, cfg, variant=variant,
                           clusters_per_client=10, seed=0,
                           options=EngineOptions(device=args.device),
                           align=AlignOptions(protocol="oprf"))
        print(f"{variant:9s} {rep.metric:6.3f} {rep.n_train:8d} "
              f"{rep.align_seconds:8.3f} {rep.coreset_seconds:9.3f} "
              f"{rep.train_seconds:8.3f} {rep.total_seconds:8.3f}")


if __name__ == "__main__":
    main()
