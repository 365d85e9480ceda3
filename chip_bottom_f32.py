"""K1/K2's tile geometry on the card: the rows a CTA of
``csrc/splitnn_bottom.cu`` takes, measured side by side.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_bottom_f32.py

It launches the kernels' C launchers at two tile geometries,
``kernel.rows_per_cta(o)`` (what the wrappers take) and the first
design's ``THREADS // o`` rows a CTA (where they differ, o <= 2): the
f32 K1/K2 at the main paths' shapes (the HI eval block (3, 512, 11)
→ 8 with ReLU and lr's o = 1 without, a 700-row train step with
duplicates out of (3, 49,000, 11); YP's eval block (3, 512, 30) → 1 and
a 3,570-row step out of (3, 249,900, 30)), and the fp8 wire K1/K2 at
the HI eval block, lr's o = 1 and the train step (writing ``pre``).
Every variant's outputs must equal the shipped wrappers' bit for bit.
Device µs a launch (``torch.profiler``, the mean over 50 launches) is
taken twice a variant, in turns (the variants in order, then in
reverse).  One JSON line a shape; the last line is nvidia-smi's name
and power limit.  Exits non-zero without a card.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def launch_us(fn, reps: int = 50) -> float:
    """Mean device µs of one ``bottom_kernel`` launch over ``reps``
    calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for ev in prof.key_averages():
        if (ev.device_type == torch.autograd.DeviceType.CUDA
                and "bottom_kernel" in ev.key):
            t = getattr(ev, "device_time_total", None)
            total += getattr(ev, "cuda_time_total", 0) if t is None else t
            count += ev.count
    return total / count


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_bottom_f32: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.kernels.splitnn_bottom.kernel import (
        THREADS, rows_per_cta, splitnn_bottom_cuda, splitnn_bottom_fp8_cuda,
        splitnn_bottom_fp8_gather_cuda, splitnn_bottom_gather_cuda)

    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rnd = lambda *shape, scale=1.0: torch.randn(
        shape, generator=gen, device=dev) * scale

    def step_idx(n, bsz):
        idx = torch.randint(0, n, (bsz,), generator=gen, device=dev,
                            dtype=torch.int32)
        idx[1::50] = idx[0]
        return idx

    hi = rnd(3, 49_000, 11)
    yp = rnd(3, 249_900, 30)
    cases = []
    for name, slab, o, relu, bsz, fp8 in (
            ("HI eval block", hi, 8, True, None, False),
            ("HI lr eval block", hi, 1, False, None, False),
            ("HI train step", hi, 8, True, 700, False),
            ("YP eval block", yp, 1, False, None, False),
            ("YP step", yp, 1, False, 3_570, False),
            ("fp8 HI eval block", hi, 8, True, None, True),
            ("fp8 HI lr eval block", hi, 1, False, None, True),
            ("fp8 HI train step, pre", hi, 8, True, 700, True)):
        m, n, d = slab.shape
        x = slab if bsz else slab[:, :512].contiguous()
        w, b = rnd(m, d, o, scale=d ** -0.5), rnd(m, o, scale=0.1)
        cases.append((name, x, w, b, relu,
                      None if bsz is None else step_idx(n, bsz), fp8))

    for name, x, w, b, relu, idx, fp8 in cases:
        m, n, d = x.shape
        o = w.shape[2]
        bsz = n if idx is None else idx.shape[0]
        if fp8:
            shipped = (splitnn_bottom_fp8_cuda(x, w, b, relu, True)
                       if idx is None else splitnn_bottom_fp8_gather_cuda(
                           idx, x, w, b, relu, True))
        else:
            shipped = (splitnn_bottom_cuda(x, w, b, relu) if idx is None
                       else splitnn_bottom_gather_cuda(idx, x, w, b, relu),)
        outs = [torch.empty_like(t) for t in shipped]
        ptrs = [t.data_ptr() for t in outs]
        variants = {}
        for rows in sorted({max(1, THREADS // o), rows_per_cta(o)}):
            if fp8 and rows % 8:
                continue
            if idx is None:
                fn = build.function("splitnn_bottom",
                                    "splitnn_bottom_fp8_launch" if fp8
                                    else "splitnn_bottom_launch",
                                    3 + len(outs), 6)
                args = (x.data_ptr(), w.data_ptr(), b.data_ptr(), *ptrs,
                        m, n, d, o, int(relu), rows)
            else:
                fn = build.function("splitnn_bottom",
                                    "splitnn_bottom_fp8_gather_launch" if fp8
                                    else "splitnn_bottom_gather_launch",
                                    4 + len(outs), 7)
                args = (idx.data_ptr(), x.data_ptr(), w.data_ptr(),
                        b.data_ptr(), *ptrs, m, n, bsz, d, o, int(relu),
                        rows)

            def call(fn=fn, args=args):
                build.check(build.launch(fn, dev, *args), name)
            call()
            torch.cuda.synchronize()
            for got, want in zip(outs, shipped):
                if not torch.equal(got.view(torch.int32),
                                   want.view(torch.int32)):
                    raise AssertionError(f"{name}: rows={rows} differs from "
                                         "the shipped kernel")
            variants[f"rows={rows}"] = call
        order = list(variants) + list(variants)[::-1]
        times = {k: [] for k in variants}
        for k in order:
            times[k].append(launch_us(variants[k]))
        emit({"shape": name, "m_b_d_o": [m, bsz, d, o], "fp8": fp8,
              "device_us": times, "bitwise_equal_to_shipped": True})
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
