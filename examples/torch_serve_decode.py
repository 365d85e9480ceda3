"""Serve a small model with batched requests on the PyTorch port:
prefill + greedy decode (``examples/serve_decode.py`` on ``repro_torch``).

    PYTHONPATH=src python examples/torch_serve_decode.py \\
        --arch mamba2-1.3b --requests 4 --new-tokens 16 [--device cpu]

Exercises the framework's serving substrate — ring-buffer / SSM-state
caches, batched single-token serve steps — on a reduced config, on
``--device`` (default: the CUDA card, where attention and the SSM scan
take the hand-written kernels).
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import api
from repro_torch.serve.engine import greedy_decode


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b", choices=ARCH_IDS)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    dev = torch.device(args.device)
    cfg = get_config(args.arch).reduced()
    params = api.init_params(0, cfg, device=dev)
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(rng.integers(
        0, cfg.vocab, (args.requests, args.prompt_len)), dtype=torch.int32,
        device=dev)

    extra = None
    if cfg.family == "audio":
        extra = torch.as_tensor(rng.normal(
            0, 1, (args.requests, cfg.enc_seq, cfg.d_model)),
            dtype=torch.float32, device=dev)
    if cfg.family == "vlm":
        extra = torch.as_tensor(rng.normal(
            0, 1, (args.requests, cfg.vision_tokens, cfg.d_model)),
            dtype=torch.float32, device=dev)

    t0 = time.perf_counter()
    out = greedy_decode(params, cfg, prompts, args.new_tokens,
                        extra_embeds=extra)
    out = out.cpu().numpy()
    dt = time.perf_counter() - t0
    toks = args.requests * args.new_tokens
    print(f"arch={cfg.arch_id} batch={args.requests} "
          f"decoded {args.new_tokens} tokens/request "
          f"in {dt:.2f}s ({toks/dt:.1f} tok/s on {dev.type})")
    for i, row in enumerate(out):
        print(f"req{i}: {row.tolist()}")


if __name__ == "__main__":
    main()
