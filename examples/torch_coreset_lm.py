"""Beyond-paper, on the PyTorch port: Cluster-Coreset weights driving
WEIGHTED LM TRAINING (``examples/coreset_lm.py`` on ``repro_torch``).

The paper's Eq. (2) is model-agnostic; this example applies it to the LLM
stack: each "client" holds a vertical slice of per-sequence feature
embeddings, Cluster-Coreset selects representative sequences and weights
them, and a reduced assigned-architecture LM trains with the weighted loss
— the framework's ``weights`` batch key end to end.

    PYTHONPATH=src python examples/torch_coreset_lm.py \\
        --arch tinyllama-1.1b --steps 30 [--device cpu]

Everything runs on ``--device`` (default: the CUDA card).
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.coreset import cluster_coreset
from repro_torch.data.pipeline import synthesize_tokens
from repro_torch.data.vertical import partition_features
from repro_torch.train.steps import init_train_state, make_train_step


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b", choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--pool", type=int, default=512,
                    help="candidate sequence pool size")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--clusters", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    dev = torch.device(args.device)
    cfg = get_config(args.arch).reduced()
    rng = np.random.default_rng(0)

    # --- candidate pool: sequences + per-sequence features on 3 clients
    pool = synthesize_tokens(rng, args.pool, args.seq, cfg.vocab)
    # stub per-sequence embeddings (e.g. pooled encoder features),
    # vertically partitioned — each client sees its own feature slice
    feats = np.stack([np.bincount(row, minlength=cfg.vocab)[:24]
                      for row in pool]).astype(np.float32)
    labels = (feats[:, :8].sum(1) > np.median(feats[:, :8].sum(1))
              ).astype(np.int64)
    part = partition_features(feats, labels, 3)

    res = cluster_coreset(part, args.clusters, seed=0, device=dev)
    print(f"coreset: {len(res.indices)}/{args.pool} sequences "
          f"({res.n_groups} CT-groups), weight range "
          f"[{res.weights.min():.2f}, {res.weights.max():.2f}]")

    core_tokens = pool[res.indices]
    core_weights = res.weights

    params, opt = init_train_state(0, cfg, device=dev)
    step = make_train_step(cfg, lr=3e-4)
    order = rng.permutation(len(core_tokens))
    t = lambda a, dtype: torch.as_tensor(a, dtype=dtype, device=dev)
    for i in range(args.steps):
        idx = order[(i * args.batch) % len(order):][:args.batch]
        if len(idx) < args.batch:
            order = rng.permutation(len(core_tokens))
            idx = order[:args.batch]
        batch = {"tokens": t(core_tokens[idx], torch.int32),
                 "labels": t(core_tokens[idx], torch.int32),
                 "weights": t(core_weights[idx], torch.float32)}
        if cfg.family == "vlm":
            batch["patches"] = torch.zeros(
                (args.batch, cfg.vision_tokens, cfg.d_model), device=dev)
        if cfg.family == "audio":
            batch["frames"] = torch.zeros(
                (args.batch, cfg.enc_seq, cfg.d_model), device=dev)
        params, opt, metrics = step(params, opt, batch)
        if i % 5 == 0 or i == args.steps - 1:
            print(f"step {i:3d}  weighted-loss "
                  f"{float(metrics['loss']):.4f}")


if __name__ == "__main__":
    main()
