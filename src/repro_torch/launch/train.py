"""Training launcher (the port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --batch 2 --seq 2048 --steps 6 [--reduced] [--ckpt out.npz]

    torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch tinyllama-1.1b --batch 8 --seq 2048 --steps 6 --mesh 2,2

The reference places params with its sharding rules under ``use_mesh``
and runs its step there; so does the port, on ``torch.distributed``
(``sharding``).  The mesh: ``--mesh D,M`` a ``(data, model)`` mesh, or
``--mesh P,D,M`` a ``(pod, data, model)`` one (batch rows over pod and
data), over the world the process is a rank of (D·M or P·D·M its
size), else with ``--reduced`` the host mesh (``make_host_mesh``, the
reference's), else ``(world, 1)`` over a world, and one device where
there is none.  The reference's ``make_production_mesh`` (a TPU pod's
(16, 16), or (2, 16, 16)) is ``launch.mesh.make_production_mesh``; it
needs a world of 256 or 512 ranks, which ``--mesh 16,16`` or
``--mesh 2,16,16`` names.  A process
started by ``torchrun`` joins its world from the environment; one
started by ``launch.mesh.run_ranks`` is already in one.  Each rank runs
on its own card (``cuda:LOCAL_RANK``, or the one ``run_ranks`` set)
unless ``--device cpu``; the backend is ``launch.mesh.default_backend``.
``REPRO_SHARDING_PROFILE`` picks the profile (``"2d"`` or ``"fsdp"``).
Batches come from ``data.pipeline.token_batch_iterator`` (seed 0, with
uniform Eq.(2) weights, stub frames or patches where the family takes
them), the same on every rank, which takes its rows; params from seed 0
on the device; ``--ckpt`` saves the whole params after the last step
(rank 0 writes).  Rank 0 prints the log lines.
"""
import argparse
import math
import os
import time


def _mesh(args, device):
    """The mesh to train on: (mesh, whether this process started a
    process group it must end)."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import (default_backend, make_host_mesh,
                                         make_pod_mesh, make_train_mesh)

    started = False
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if not dist.is_initialized() and world > 1:
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(default_backend(world, device),
                                init_method="env://")
        started = True
    if args.mesh:
        sizes = [int(v) for v in args.mesh.split(",")]
        if len(sizes) not in (2, 3):
            raise ValueError(f"--mesh {args.mesh}: give D,M or P,D,M")
        n = math.prod(sizes)
        if not dist.is_initialized() or dist.get_world_size() != n:
            have = dist.get_world_size() if dist.is_initialized() else 1
            raise ValueError(f"--mesh {args.mesh} needs a world of {n} "
                             f"ranks, this one has {have}")
        make = make_train_mesh if len(sizes) == 2 else make_pod_mesh
        return make(*sizes), started
    if args.reduced or not dist.is_initialized():
        return make_host_mesh(), started
    return make_train_mesh(dist.get_world_size(), 1), started


def _device(name: str):
    import torch

    from repro_torch.config import resolve_device
    dev = resolve_device(name)
    if dev.type == "cuda" and dev.index is None:
        local = os.environ.get("LOCAL_RANK")
        dev = torch.device("cuda", int(local) if local is not None
                           else torch.cuda.current_device())
    return dev


def main(argv=None):
    """Train as the arguments say; returns (params, cfg, mesh): this
    rank's trained blocks, the config and the mesh."""
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
    ap.add_argument("--mesh", default="",
                    help="D,M: a (data, model) mesh over the world; "
                         "P,D,M: a (pod, data, model) one")
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import token_batch_iterator
    from repro_torch.sharding import use_mesh
    from repro_torch.train.steps import init_train_state, make_train_step

    dev = _device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    mesh, started = _mesh(args, dev)
    lead = not dist.is_initialized() or dist.get_rank() == 0
    try:
        with use_mesh(mesh):
            params, opt = init_train_state(0, cfg, device=dev)
            step_fn = make_train_step(cfg, lr=args.lr)
            it = token_batch_iterator(
                args.batch, args.seq, cfg.vocab, seed=0,
                d_model=cfg.d_model,
                frames=cfg.enc_seq if cfg.family == "audio" else 0,
                patches=cfg.vision_tokens if cfg.family == "vlm" else 0,
                weights=True)
            t0 = time.perf_counter()
            for i in range(args.steps):
                batch = {k: torch.from_numpy(v).to(dev)
                         for k, v in next(it).items()}
                params, opt, metrics = step_fn(params, opt, batch)
                if lead and (i % args.log_every == 0
                             or i == args.steps - 1):
                    loss, ce = float(metrics["loss"]), float(metrics["ce"])
                    toks = args.batch * args.seq * (i + 1)
                    dt = time.perf_counter() - t0
                    print(f"step {i:4d}  loss {loss:.4f}  ce {ce:.4f}  "
                          f"{toks/dt:.0f} tok/s", flush=True)
            if args.ckpt:
                save_checkpoint(args.ckpt, params, step=args.steps, cfg=cfg)
                if lead:
                    print(f"saved {args.ckpt}")
    finally:
        if started:
            dist.destroy_process_group()
    return params, cfg, mesh


if __name__ == "__main__":
    main()
