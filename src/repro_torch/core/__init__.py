"""TreeCSS core, ported: the paper's pipeline, k-NN and SplitNN jobs.

  tpsi      — two-party PSI primitives (RSA blind signature, OPRF/OT)
  mpsi      — Tree-MPSI (ours) + Path/Star baselines, volume-aware scheduling
  kmeans    — batched K-Means on the device (CUDA Lloyd and assign kernels)
  coreset   — Cluster-Coreset construction + distance-rank weighting
  splitnn   — SplitNN model zoo (lr/mlp/linreg), training and eval
              entry points, and the VFL k-NN vote
  treecss   — end-to-end pipeline: align → coreset → train/eval or k-NN
  he        — additive Paillier (protocol-fidelity stub)
"""
from repro_torch.core.coreset import (ClientClustering, CoresetResult,
                                      cluster_coreset, select_coreset)
from repro_torch.core.kmeans import kmeans, kmeans_fit
from repro_torch.core.mpsi import (MPSI, MPSIStats, path_mpsi, star_mpsi,
                                   tree_mpsi)
from repro_torch.core.splitnn import (SplitNNConfig, TrainReport, evaluate,
                                      init_splitnn, knn_predict, predict,
                                      splitnn_forward, train_splitnn)
from repro_torch.core.tpsi import TPSIResult, run_tpsi, tpsi_oprf, tpsi_rsa
from repro_torch.core.treecss import PipelineReport, run_pipeline

__all__ = [
    "ClientClustering", "CoresetResult", "cluster_coreset", "select_coreset",
    "kmeans", "kmeans_fit",
    "MPSI", "MPSIStats", "path_mpsi", "star_mpsi", "tree_mpsi",
    "SplitNNConfig", "TrainReport", "evaluate", "init_splitnn",
    "knn_predict", "predict", "splitnn_forward", "train_splitnn",
    "TPSIResult", "run_tpsi", "tpsi_oprf", "tpsi_rsa",
    "PipelineReport", "run_pipeline",
]
