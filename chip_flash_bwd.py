"""K11's backward (``csrc/flash_attention_bwd.cu``) on the card, for a
parent-against-change comparison and for what binds it.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_flash_bwd.py [--src DIR] [--tag NAME] [--variants]

``--src`` is the ``src`` directory of the tree to measure (default: this
checkout's).  Another tree, such as a parent commit unpacked with ``git
archive`` into a git-ignored directory, is measured by this same script,
its kernels built from its own sources into its own ``build/``; run the
two in turns (parent, change, change, parent) in one call.  The script
reaches the port through ``flash_attention_cuda`` and
``flash_attention_bwd_cuda``, passing the forward's LSE where the tree's
backward takes it (trees before the LSE recompute their statistics).

At each timed shape of ``chip_smoke.py``'s backward rows (bf16, B = 2:
tinyllama-1.1b's train step, hymba-1.5b, internvl2-1b, olmoe-1b-7b,
gemma2-9b, whisper-large-v3's encoder and its cross-attention), on seeded
operands (both trees see the same): the SHA-256 of the forward's output
asked for no LSE, and of dq, dk, dv (equal lines mean equal bits across
trees); device µs a call, the sum of the
backward's kernels, and each kernel's (``torch.profiler``, the mean over
20 calls, 2 sessions); event µs a call (median of 20).

``--variants`` (this tree) builds copies of the source into
``build/fa_bwd_variants/`` (one nvcc each, all at once) with one of
``BwdShape``'s constants changed, and times each at the tinyllama, olmoe
and gemma2 shapes and at stablelm-12b's (B 2, S 2,048, H 32, KV 8, Dh
160, causal; no train path of this repository runs it) through its own C
launcher, each with the heads of a kv head split over 1, 2 and 4 dk/dv
CTAs where G allows (``hs`` heads a CTA), every output held to the plain
version within the card's bf16 check:

- ``shipped``      the source as it is;
- ``pg1``, ``pg4``  dS·K, Pᵀ·dO and dSᵀ·Q a column pair at a time at
                   every Dh (the first build's order: 2 accumulators
                   between two products into one), or 4 pairs at a time
                   at every Dh (the source: 4 up to Dh 128, else 1);
- ``pieces2``      p and ds in two bf16 pieces (16 significand bits);
- ``dq_min2``, ``dq_min3``  the dq kernel asks for 2 CTAs an SM at every
                   Dh (at most 255 registers a thread), or for 3 at Dh 128
                   (168; the source: 4 up to Dh 64, else 2);
- ``bm64``         the dk/dv kernel's query tiles of 64 rows up to Dh 128
                   (the source: 64 up to Dh 64, else 32);
- ``bm16``         its query tiles of 16 rows at Dh 256.

One JSON line a shape, tagged ``--tag``; the last line is nvidia-smi's
name and power limit.  Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import inspect
import json
import math
import os
import re
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
MARK = "flash_attention_bwd_"
#: (name, (B, S_q, S_k, H, KV, Dh), mask)
SHAPES = (
    ("tinyllama-1.1b", (2, 2048, 2048, 32, 4, 64), dict(causal=True)),
    ("hymba-1.5b", (2, 2176, 2176, 25, 5, 64),
     dict(causal=True, window=1024, prefix=128)),
    ("internvl2-1b", (2, 2304, 2304, 14, 2, 64), dict(causal=True)),
    ("olmoe-1b-7b", (2, 2048, 2048, 16, 16, 128), dict(causal=True)),
    ("gemma2-9b", (2, 2048, 2048, 16, 8, 256),
     dict(causal=True, window=4096, logit_cap=50.0)),
    ("whisper-large-v3 encoder", (2, 1500, 1500, 20, 20, 64),
     dict(causal=False)),
    ("whisper-large-v3 cross-attention", (2, 448, 1500, 20, 20, 64),
     dict(causal=False)))
#: a Dh = 160 shape, timed with ``--variants`` only
VARIANT_ONLY = (("stablelm-12b", (2, 2048, 2048, 32, 8, 160),
                 dict(causal=True)),)
VARIANT_SHAPES = ("tinyllama-1.1b", "olmoe-1b-7b", "gemma2-9b",
                  "stablelm-12b")
#: the shipped constants, and each variant's change of one
CONSTS = {"pg": "static constexpr int PG = DP <= 128 ? 4 : 1;",
          "pieces": "static constexpr int PIECES = 3;",
          "dq": "static constexpr int DQ_MIN_CTAS = DP <= 64 ? 4 : 2;",
          "bm": "static constexpr int BM = DP <= 64 ? 64 : 32;"}
VARIANTS = {"shipped": [],
            "pg1": [("pg", "static constexpr int PG = 1;")],
            "pg4": [("pg", "static constexpr int PG = 4;")],
            "pieces2": [("pieces", "static constexpr int PIECES = 2;")],
            "dq_min2": [("dq", "static constexpr int DQ_MIN_CTAS = 2;")],
            "dq_min3": [("dq", "static constexpr int DQ_MIN_CTAS = "
                         "DP <= 64 ? 4 : DP == 128 ? 3 : 2;")],
            "bm64": [("bm", "static constexpr int BM = "
                      "DP <= 128 ? 64 : 32;")],
            "bm16": [("bm", "static constexpr int BM = "
                      "DP <= 64 ? 64 : DP <= 160 ? 32 : 16;")]}


def emit(tag, obj) -> None:
    print(json.dumps({"tag": tag, **obj}), flush=True)


def operands(shape, dev):
    b, sq, sk, h, kv, dh = shape
    rng = np.random.default_rng([SEED, *shape])
    g = lambda *s: torch.from_numpy(rng.normal(size=s).astype(
        np.float32)).to(dev, torch.bfloat16)
    return g(b, sq, h, dh), g(b, sk, kv, dh), g(b, sk, kv, dh), g(b, sq, h, dh)


def sha256(tensors) -> str:
    return hashlib.sha256(b"".join(
        t.contiguous().view(torch.int16).cpu().numpy().tobytes()
        for t in tensors)).hexdigest()


def device_us(fn, reps: int = 20, tries: int = 3):
    """(Mean device µs a call of the backward's kernels, {kernel: µs a
    call}) over ``reps`` calls; a profiler session that recorded none is
    run again, up to ``tries``."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        per = {}
        for ev in prof.key_averages():
            if (ev.device_type == torch.autograd.DeviceType.CUDA
                    and MARK in ev.key):
                t = getattr(ev, "device_time_total", None)
                t = getattr(ev, "cuda_time_total", 0) if t is None else t
                hit = re.search(r"flash_attention_bwd_\w+", ev.key)
                name = hit[0] if hit else ev.key
                per[name] = per.get(name, 0.0) + t / reps
        if per:
            return sum(per.values()), per
    raise RuntimeError("the profiler recorded no backward launch")


def event_us(fn, reps: int = 20) -> float:
    for _ in range(3):
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
        times.append(start.elapsed_time(end) * 1e3)
    return float(np.median(times))


def bf16_check(got, want) -> float:
    """The largest |got - want| / (2^-7·|want| + 1e-4·max|want|) over the
    three gradients: at most 1 passes ``chip_smoke.py``'s bf16 check."""
    worst = 0.0
    for x, w in zip(got, want):
        w = w.float()
        tol = 2.0 ** -7 * w.abs() + 1e-4 * float(w.abs().max())
        worst = max(worst, float(((x.float() - w).abs() / tol).max()))
    return worst


def ptxas_counts(report: str) -> dict:
    """{kernel<DP>: "R registers, S spill bytes"} of a ``-Xptxas -v``
    report."""
    out, name = {}, None
    for ln in report.splitlines():
        hit = re.search(r"entry function '\w*?(flash_attention_bwd_(?:dq|"
                        r"dkdv|sum)\w*?)(?:ILi(\d+)E|[A-Z]\w*')", ln)
        if hit:
            name = hit[1] + (f"<{hit[2]}>" if hit[2] else "")
        spill = re.search(r"(\d+) bytes spill stores", ln)
        if name and spill:
            out[name] = f"{spill[1]} spill bytes"
        regs = re.search(r"Used (\d+) registers", ln)
        if name and regs:
            out[name] = f"{regs[1]} registers, " + out.get(name, "")
    return out


def variant_libraries():
    """({name: ctypes launcher}, {name: ptxas lines}) of the variant
    copies, built at once."""
    from repro_torch.kernels import build
    src = (build.CSRC / build.SOURCES["flash_attention_bwd"]).read_text()
    out_dir = os.path.join(ROOT, "build", "fa_bwd_variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for key, new in subs:
            if CONSTS[key] not in text:
                raise RuntimeError(f"{name}: the source no longer holds "
                                   f"{CONSTS[key]!r}")
            text = text.replace(CONSTS[key], new)
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", cu[:-3] + ".so", cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns, ptxas = {}, {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {name}:\n{out}")
        ptxas[name] = ptxas_counts(out)
        fn = ctypes.CDLL(os.path.join(out_dir, name + ".so")
                         ).flash_attention_bwd_launch
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_longlong] * 11
                       + [ctypes.c_double] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns, ptxas


def variant_times(fns, q, k, v, o, do, lse, want, kw):
    """{variant: {hs: [device µs, worst check ratio]}} in turns (in
    order, then in reverse)."""
    from repro_torch.kernels import build
    b, sq, h, dh = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    out = {}
    for name in [*fns, *reversed(list(fns))]:
        for hs in sorted({g, -(-g // 2), -(-g // 4)}):
            chunks = -(-g // hs)
            part = (torch.empty((chunks, 2, k.numel()), dtype=torch.float32,
                                device=q.device) if chunks > 1 else None)
            grads = [torch.empty_like(t) for t in (q, k, v)]
            d_row = torch.empty((b, h, sq), dtype=torch.float32,
                                device=q.device)

            def call():
                err = fns[name](
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    do.data_ptr(), lse.data_ptr(),
                    *(t.data_ptr() for t in grads), d_row.data_ptr(),
                    None if part is None else part.data_ptr(), b, sq, sk, h,
                    kvh, dh, hs, int(kw.get("causal", True)),
                    int(kw.get("window", 0)), int(kw.get("prefix", 0)), 1,
                    1.0 / math.sqrt(dh), float(kw.get("logit_cap", 0.0)),
                    build.stream(q.device))
                if err:
                    raise RuntimeError(f"{name}: cudaError {err}")

            call()
            torch.cuda.synchronize()
            ratio = bf16_check(grads, want)
            t = device_us(call)[0]
            out.setdefault(name, {}).setdefault(hs, []).append([t, ratio])
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--tag", default="change")
    ap.add_argument("--variants", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_flash_bwd: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ref
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bwd_cuda, flash_attention_cuda)

    dev = torch.device("cuda")
    build.build_all(["flash_attention", "flash_attention_bwd"])
    emit(args.tag, {"phase": "build", "src": os.path.relpath(
        os.path.abspath(args.src), ROOT), "ptxas": ptxas_counts(
            build.PTXAS_REPORT.get("flash_attention_bwd", ""))})
    takes_lse = "lse" in inspect.signature(flash_attention_bwd_cuda).parameters
    if args.variants:
        fns, ptxas = variant_libraries()
        emit(args.tag, {"phase": "variant_build", "ptxas": ptxas})
    for name, shape, kw in SHAPES + (VARIANT_ONLY if args.variants else ()):
        q, k, v, do = operands(shape, dev)
        fwd_sha = sha256([flash_attention_cuda(q, k, v, **kw)])
        if takes_lse:
            o, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
            call = lambda: flash_attention_bwd_cuda(q, k, v, o, do, lse, **kw)
        else:
            o, lse = flash_attention_cuda(q, k, v, **kw), None
            call = lambda: flash_attention_bwd_cuda(q, k, v, o, do, **kw)
        got = call()
        torch.cuda.synchronize()
        total, per = device_us(call)
        row = dict(phase="shape", name=name, shape=list(shape), **kw,
                   fwd_sha256=fwd_sha, sha256=sha256(got), device_us=total, kernels_us=per,
                   device_us_again=device_us(call)[0],
                   event_us=event_us(call))
        if args.variants and name in VARIANT_SHAPES:
            want = ref.flash_attention_bwd(q, k, v, o, do, **kw)
            row["check_ratio"] = bf16_check(got, want)
            row["variants"] = variant_times(fns, q, k, v, o, do, lse, want,
                                            kw)
            del want
        emit(args.tag, row)
        del q, k, v, do, o, lse, got
        torch.cuda.empty_cache()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
