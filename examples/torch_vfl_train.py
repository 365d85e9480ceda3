"""End-to-end VFL run on the PyTorch port (``examples/vfl_train.py`` on
``repro_torch``: the paper's kind, federated training).

    PYTHONPATH=src python examples/torch_vfl_train.py --dataset HI \
        --model mlp --variant treecss --clusters 12 [--protocol rsa|oprf] \
        [--full] [--device cpu]

Stages: Tree-MPSI alignment → Cluster-Coreset selection → weighted
SplitNN training to the paper's convergence criterion (or the k-NN
vote) → test evaluation.  Prints the stage report.  Every device stage
runs on ``--device`` (default: the CUDA card).
"""
import argparse

from repro_torch.config import AlignOptions, EngineOptions
from repro_torch.core import SplitNNConfig, run_pipeline
from repro_torch.data.table2 import dataset_partitions


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="BA",
                    choices=["BA", "MU", "RI", "HI", "BP", "YP"])
    ap.add_argument("--model", default="lr",
                    choices=["lr", "mlp", "linreg", "knn"])
    ap.add_argument("--variant", default="treecss",
                    choices=["starall", "treeall", "starcss", "treecss",
                             "pathall", "pathcss"])
    ap.add_argument("--clusters", type=int, default=12)
    ap.add_argument("--protocol", default="oprf", choices=["rsa", "oprf"])
    ap.add_argument("--no-weights", action="store_true")
    ap.add_argument("--full", action="store_true",
                    help="paper-scale dataset sizes")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    tr, te = dataset_partitions(args.dataset, quick=not args.full,
                                seed=args.seed)
    n_classes = {"BA": 2, "MU": 2, "RI": 2, "HI": 2, "BP": 4,
                 "YP": 0}[args.dataset]
    if args.model == "linreg":
        n_classes = 0
    cfg = SplitNNConfig(model=args.model, n_classes=n_classes,
                        lr=0.05 if args.model != "mlp" else 0.01,
                        batch_size=max(8, tr.n_samples // 100),
                        max_epochs=200, seed=args.seed)
    rep = run_pipeline(tr, te, cfg, variant=args.variant,
                       clusters_per_client=args.clusters,
                       use_weights=not args.no_weights, seed=args.seed,
                       options=EngineOptions(device=args.device),
                       align=AlignOptions(protocol=args.protocol))

    metric_name = "MSE" if n_classes == 0 else "accuracy"
    print(f"\n=== {args.variant.upper()} on {args.dataset} "
          f"({args.model}) ===")
    print(f"aligned samples : {rep.mpsi.intersection.size}")
    print(f"MPSI rounds     : {rep.mpsi.rounds} "
          f"({rep.mpsi.total_bytes/1e6:.2f} MB)")
    print(f"training set    : {rep.n_train}"
          + (f" (coreset, {rep.coreset.n_groups} CT-groups)"
             if rep.coreset else " (full)"))
    if rep.train.epochs:
        print(f"train epochs    : {rep.train.epochs} "
              f"({rep.train.comm_bytes/1e6:.2f} MB instance-wise comm)")
    print(f"align/coreset/train s: {rep.align_seconds:.2f} / "
          f"{rep.coreset_seconds:.2f} / {rep.train_seconds:.2f}")
    print(f"total           : {rep.total_seconds:.2f}s")
    print(f"test {metric_name:9s}: {rep.metric:.4f}")


if __name__ == "__main__":
    main()
