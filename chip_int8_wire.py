"""A quantized wire's path on the card, for a parent-against-change
comparison.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_int8_wire.py [--src DIR] [--tag NAME] [--quant int8|fp8]

``--src`` is the ``src`` directory of the tree to measure (default: this
checkout's).  Another tree, such as a parent commit unpacked with ``git
archive`` into a git-ignored directory, is measured by this same script,
and its kernels are built from its own sources into its own
``build/``; run the two in turns (parent, change, change, parent) in one
call.  The script reaches the port only through entry points every
tree since the int8 slice has (``--quant``, default int8, picks the
wire):

- ``train.vfl._bottom_acts`` under the wire with the kernels, the
  bottom pass plus the wire rounding that evaluation, serving and a
  train step call: the eval block (3, 512, 11) → 8 with ReLU and a
  serving dispatch (3, 64, 11) → 8 under ``no_grad``, and a 700-row
  train step with duplicates out of the HI slab (3, 49,000, 11), its
  forward and the gradient of w and b: event ms a call (median of 50),
  device ms a call and device kernels a call (``torch.profiler``);
- the f32 K1 and K2 wrappers (``splitnn_bottom_cuda`` at the eval block,
  ``splitnn_bottom_gather_cuda`` at the train step), the same numbers,
  then the host time a wrapper call takes to enqueue (µs, mean of 2,000
  calls, no synchronize);
- the bits of the f32 K1 and K2: the SHA-256 of their outputs on the
  seeded operands above (K1 at the eval block with ReLU and at lr's
  o = 1 without, K2 at the train step at both widths), and of those
  operands, so that two trees' lines compare bit for bit; K2 must equal
  K1 on the gathered rows;
- the HI treecss × {mlp, lr} jobs under the wire, ``run_pipeline`` at
  full size with Table-2's settings (as ``chip_smoke.py``'s quant phase
  runs them), one untimed run each, then 3: ``eval_wall_s`` (the
  ``pipeline.serve`` span), ``ms_per_step``, the job's wall, accuracy,
  epochs, ``comm_bytes`` and ``gather_payload_bytes``;
- ``VFLScoringEngine(slots=64, quant=...)`` over the 30,000 HI test rows
  as ``chip_smoke.py``'s seeded requests of 1-256 rows, with the mlp
  job's params, kernels and plain versions in turns, 3 runs each; then
  one run of each under ``torch.profiler`` (device ms, busy share, top
  device ops) and ``cProfile`` (the host functions by own time).

One JSON line each, tagged ``--tag``; the last line is nvidia-smi's name
and power limit.  Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import cProfile
import hashlib
import json
import os
import pstats
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0


def emit(tag, obj) -> None:
    print(json.dumps({"tag": tag, **obj}), flush=True)


def event_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    """Median of ``reps`` calls, CUDA events around each."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_profile(fn, reps: int = 20):
    """(device ms a call, device kernels a call, {op: device ms a call}
    for the top 8, profiled wall ms a call) over ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    ms, launches, per_op = 0.0, 0.0, {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = getattr(ev, "cuda_time_total", 0)
        ms += t / 1e3 / reps
        launches += ev.count / reps
        per_op[ev.key] = t / 1e3 / reps
    top = dict(sorted(per_op.items(), key=lambda kv: -kv[1])[:8])
    return ms, launches, top, wall


def partitions():
    """HI at its full spec, 70/30, 3 clients (``chip_smoke.partitions``)."""
    from repro_torch.data.synthetic import DATASETS, make_dataset
    from repro_torch.data.vertical import partition_features
    spec = DATASETS["HI"]
    x, y = make_dataset(spec, seed=SEED)
    order = np.random.default_rng(SEED + 1).permutation(spec.n_instances)
    n_tr = int(spec.n_instances * 0.7)
    return (partition_features(x[order[:n_tr]], y[order[:n_tr]], 3),
            partition_features(x[order[n_tr:]], y[order[n_tr:]], 3))


def host_us(fn, reps: int = 2000) -> float:
    """Mean host µs of ``fn`` over ``reps`` calls after 100 unmeasured,
    with no synchronize (what the host pays to enqueue)."""
    for _ in range(100):
        fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / reps
    torch.cuda.synchronize()
    return us


def call_rows(tag, tr, dev, quant):
    from repro_torch.core.splitnn import SplitNNConfig
    from repro_torch.kernels.splitnn_bottom.kernel import (
        splitnn_bottom_cuda, splitnn_bottom_gather_cuda)
    from repro_torch.kernels.splitnn_bottom.ops import int8_rows
    from repro_torch.train.vfl import _bottom_acts, pack_slab

    rng = np.random.default_rng(SEED)
    slab = torch.from_numpy(pack_slab(tr.client_features)[:, :49_000]
                            ).contiguous().to(dev)
    m, n, d = slab.shape
    g = lambda *shape, scale: (torch.from_numpy(rng.normal(
        size=shape).astype(np.float32)) * scale).to(dev)
    cfg = SplitNNConfig(model="mlp", n_classes=2)
    w, b = g(m, d, 8, scale=d ** -0.5), g(m, 8, scale=0.1)
    idx = torch.from_numpy(rng.integers(0, n, 700).astype(np.int32)).to(dev)
    idx[1::50] = idx[0]
    x_int8 = int8_rows(slab) if quant == "int8" else None

    def acts(x, packed, i=None, rows=None):
        return _bottom_acts(packed, cfg, m, x, "kernel", i, quant, rows)

    def nograd(x):
        def fn():
            with torch.no_grad():
                return acts(x, {"bw": w, "bb": b})
        return fn

    wg, bg = w.clone().requires_grad_(), b.clone().requires_grad_()

    def step():
        out = acts(slab, {"bw": wg, "bb": bg}, idx, x_int8)
        return torch.autograd.grad(out.sum(), [wg, bg])

    eval_x = slab[:, :512].contiguous()
    k1 = lambda: splitnn_bottom_cuda(eval_x, w, b, True)
    k2 = lambda: splitnn_bottom_gather_cuda(idx, slab, w, b, True)
    for name, fn in (("eval_block", nograd(eval_x)),
                     ("serving_dispatch", nograd(slab[:, :64].contiguous())),
                     ("train_step_fwd_bwd", step),
                     ("k1_f32", k1), ("k2_f32", k2)):
        dev_ms, launches, top, _ = device_profile(fn)
        emit(tag, {"phase": "call", "name": name, "quant": quant,
                   "ms": event_ms(fn), "device_ms": dev_ms,
                   "device_kernels": launches, "top_device_ops_ms": top})

    emit(tag, {"phase": "host_path", "us": {
        "k1_wrapper": host_us(k1), "k2_wrapper": host_us(k2)}})

    sha = lambda *ts: hashlib.sha256(b"".join(
        t.contiguous().cpu().numpy().tobytes() for t in ts)).hexdigest()
    w1, b1 = g(m, d, 1, scale=d ** -0.5), g(m, 1, scale=0.1)
    bits = {"operands": sha(slab, idx, w, b, w1, b1)}
    for o, (wo, bo, relu) in ((8, (w, b, True)), (1, (w1, b1, False))):
        out1 = splitnn_bottom_cuda(eval_x, wo, bo, relu)
        out2 = splitnn_bottom_gather_cuda(idx, slab, wo, bo, relu)
        again = splitnn_bottom_cuda(slab[:, idx.long()].contiguous(), wo, bo,
                                    relu)
        if not torch.equal(out2.view(torch.int32), again.view(torch.int32)):
            raise AssertionError(f"K2 differs from K1 on its rows (o = {o})")
        bits[f"k1_o{o}"], bits[f"k2_o{o}"] = sha(out1), sha(out2)
    emit(tag, {"phase": "f32_bits", "sha256": bits})


def job_rows(tag, tr, te, dev, quant):
    from repro_torch.config import AlignOptions, EngineOptions
    from repro_torch.core.splitnn import SplitNNConfig
    from repro_torch.core.treecss import run_pipeline

    out = {}
    for model, lr in (("mlp", 0.01), ("lr", 0.05)):
        cfg = SplitNNConfig(model=model, n_classes=2, lr=lr,
                            batch_size=max(8, tr.n_samples // 100),
                            max_epochs=200, seed=SEED)

        def run():
            return run_pipeline(
                tr, te, cfg, variant="treecss", clusters_per_client=14,
                seed=SEED, options=EngineOptions(device=dev, trace=True,
                                                 quant=quant),
                align=AlignOptions(protocol="oprf", psi_backend="device"))

        run()                                   # untimed: first use
        for i in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rep = run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            emit(tag, {"phase": "job", "model": model, "run": i,
                       "quant": quant, "metric": rep.metric,
                       "epochs": rep.train.epochs, "steps": rep.train.steps,
                       "eval_wall_s": rep.tracer.total_seconds(
                           "pipeline.serve"),
                       "ms_per_step": rep.train.train_seconds * 1e3
                       / rep.train.steps,
                       "train_wall_s": rep.train_wall_seconds,
                       "total_wall_s": wall,
                       "comm_bytes": rep.train.comm_bytes,
                       "gather_payload_bytes":
                       rep.train.engine_stats.gather_payload_bytes})
        out[model] = rep.train.params, cfg
    return out["mlp"]


def serve_rows(tag, te, params, cfg, quant):
    from repro_torch.serve.vfl import VFLScoringEngine

    feats = te.client_features
    g = np.random.default_rng(SEED + 2)
    bounds, s = [], 0
    while s < te.n_samples:
        e = min(s + int(g.integers(1, 257)), te.n_samples)
        bounds.append((s, e))
        s = e
    requests = [(rid, [f[a:b] for f in feats])
                for rid, (a, b) in enumerate(bounds)]

    def serve(impl):
        eng = VFLScoringEngine(params, cfg, slots=64, bottom_impl=impl,
                               quant=quant)
        eng.score_requests(requests)
        torch.cuda.synchronize()
        return eng

    for impl in ("kernel", "ref"):              # untimed: first use
        serve(impl)
    for i in range(3):
        for impl in ("kernel", "ref"):
            t0 = time.perf_counter()
            eng = serve(impl)
            emit(tag, {"phase": "serve", "run": i, "impl": impl,
                       "quant": quant,
                       "wall_s": time.perf_counter() - t0,
                       "dispatches": eng.stats.dispatches,
                       "requests": len(bounds)})
    for impl in ("kernel", "ref"):
        dev_ms, launches, top, wall = device_profile(lambda: serve(impl),
                                                     reps=1)
        prof = cProfile.Profile()
        prof.enable()
        serve(impl)
        prof.disable()
        own = sorted(((f"{os.path.basename(path)}:{line}({fn})", tt * 1e3)
                      for (path, line, fn), (_, _, tt, _, _)
                      in pstats.Stats(prof).stats.items()),
                     key=lambda r: -r[1])[:12]
        emit(tag, {"phase": "serve_profile", "impl": impl, "quant": quant,
                   "device_ms": dev_ms, "device_kernels": launches,
                   "wall_ms_profiled": wall,
                   "device_busy_share": dev_ms / wall,
                   "top_device_ops_ms": top, "host_own_ms": own})


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--tag", default="change")
    ap.add_argument("--quant", default="int8", choices=("int8", "fp8"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_int8_wire: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.src))
    import repro_torch
    from repro_torch.kernels import build

    dev = torch.device("cuda")
    emit(args.tag, {"phase": "device", "src": os.path.relpath(
        os.path.dirname(os.path.abspath(repro_torch.__file__)), ROOT),
        "build_s": build.build_all(["splitnn_bottom"])})
    tr, te = partitions()
    call_rows(args.tag, tr, dev, args.quant)
    params, cfg = job_rows(args.tag, tr, te, dev, args.quant)
    serve_rows(args.tag, te, params, cfg, args.quant)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
