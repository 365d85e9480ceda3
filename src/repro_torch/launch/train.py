"""Training launcher (the port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --batch 2 --seq 2048 --steps 6 [--reduced] [--ckpt out.npz]

One device: the card unless ``--device cpu`` (use ``--reduced`` there).
The reference places params with its production sharding rules and runs
a pjit'd step on a mesh; the port's mesh and sharding wait for the
multi-GPU slice (ROADMAP.md queue 6).  Batches come from
``data.pipeline.token_batch_iterator`` (seed 0, with uniform Eq.(2)
weights, stub frames or patches where the family takes them), params
from seed 0 on the device; ``--ckpt`` saves the params after the last
step with ``checkpoint.save_checkpoint``, as the reference does.
"""
import argparse
import time


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true",
                    help="the config's reduced same-family variant")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.config import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import token_batch_iterator
    from repro_torch.train.steps import init_train_state, make_train_step

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params, opt = init_train_state(0, cfg, device=dev)
    step_fn = make_train_step(cfg, lr=args.lr)
    it = token_batch_iterator(
        args.batch, args.seq, cfg.vocab, seed=0, d_model=cfg.d_model,
        frames=cfg.enc_seq if cfg.family == "audio" else 0,
        patches=cfg.vision_tokens if cfg.family == "vlm" else 0,
        weights=True)
    t0 = time.perf_counter()
    for i in range(args.steps):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in next(it).items()}
        params, opt, metrics = step_fn(params, opt, batch)
        if i % args.log_every == 0 or i == args.steps - 1:
            loss, ce = float(metrics["loss"]), float(metrics["ce"])
            toks = args.batch * args.seq * (i + 1)
            dt = time.perf_counter() - t0
            print(f"step {i:4d}  loss {loss:.4f}  ce {ce:.4f}  "
                  f"{toks/dt:.0f} tok/s", flush=True)
    if args.ckpt:
        save_checkpoint(args.ckpt, params, step=args.steps)
        print(f"saved {args.ckpt}")


if __name__ == "__main__":
    main()
