"""The benchmark of the PyTorch and CUDA port, ``repro_torch``.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

runs one cell of ``BENCHMARK.json`` on the card this process finds:

1. loads the cell's configuration and traffic mix (``harness/manifest``);
2. builds the CUDA libraries the mix's kernels need, into
   ``build/repro_torch_ext/`` of the checkout, so that only a checkout's
   first run pays for ``nvcc``;
3. makes the data from ``--seed`` (``reference/data``);
4. runs one untimed warm-up job or round (lazy CUDA module loads,
   cuBLAS's set-up);
5. measures for ``--seconds`` (the mix's driver, ``drivers/``);
6. compares what the window produced with the plain reference
   (``reference/``), each number against its limit (``limits/``);
7. prints the result as the last line of its standard output, and the
   numbers compared, each beside its limit, as the last lines of its
   standard error.

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics (``metrics/``), read from the program's obs spans and
from ``torch.profiler`` over whole jobs or dispatch rounds in the
window.  ``setup_s`` runs from the process's start to the window's.
Without a CUDA card the run stops with no result; it never falls back
to the CPU.  It also stops with no result where JAX or the JAX package
the port was made from is loaded when the run ends.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.harness import env  # noqa: E402  (stdlib only)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def driver_for(cell, seed: int, device, trace: bool):
    from perfbench.harness.manifest import load_module
    mod = load_module("drivers", cell.mix["driver"])
    return mod.Driver(cell, seed, device, trace)


def card() -> dict:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ""
    return {"nvidia_smi": out}


def run_cell(cell, seed: int, seconds: float, trace: bool, *, device,
             start: float):
    """One run of ``cell`` on ``device``: (the result line, the number
    of jobs or requests compared).  The caller has made sure the device
    is there."""
    import torch

    from perfbench.harness.manifest import load_module
    from perfbench.harness.profile import warm_profiler

    device = torch.device(device)
    on_card = device.type == "cuda"
    drv = driver_for(cell, seed, device, trace)
    drv.setup()
    if trace and on_card:
        warm_profiler(device)
    if on_card:
        torch.cuda.synchronize(device)
    # what set-up made lives to the end: keep the collector off it
    gc.collect()
    gc.freeze()
    setup_s = time.time() - start
    drv.window(seconds)
    gc.unfreeze()
    if on_card:
        torch.cuda.synchronize(device)
        peak_bytes = int(torch.cuda.max_memory_allocated(device))
        kind = torch.cuda.get_device_name(device)
    else:
        peak_bytes, kind = 0, "cpu"

    metrics = {}
    breakdown = None
    if not trace:
        values = dict(drv.end_to_end(), setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        data = drv.layer_data()
        for m in cell.per_layer:
            v = load_module("metrics", m["name"]).read(data)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if data.device is not None:
            breakdown = {"device_ops": data.device.top_ops(),
                         "idle_gaps": data.device.idle_by_span(data.spans)}

    for err in drv.errors():
        print(err, file=sys.stderr)
    print(json.dumps({"perfbench": "summary", **drv.summary()}),
          file=sys.stderr)
    numbers, judged = drv.judge(device)
    checks = {}
    for name, limit in cell.limits.items():
        value = numbers.get(name)
        if value is not None and not math.isfinite(value):
            value = None            # a stage that could not be followed
        checks[name] = {"value": value, "limit": limit}
    correct = (judged > 0 and drv.failed == 0 and all(
        c["value"] is not None and c["value"] <= c["limit"]
        for c in checks.values()))

    dev = {"platform": "gpu" if on_card else "cpu", "kind": kind,
           "count": 1, "memory_peak_bytes": peak_bytes}
    if trace:
        d = drv.device_trace
        dev["busy_s"] = d.busy_s() if d is not None else 0.0
        dev["window_s"] = d.window_s if d is not None else 0.0
    result = {"correct": bool(correct), "attempted": drv.attempted,
              "failed": drv.failed, "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result, judged


def main(argv=None) -> int:
    start = env.process_start()
    args = parse(argv)
    fixed = env.prepare(ROOT)

    import torch

    from perfbench.harness.manifest import cell as load_cell

    torch.set_num_threads(env.THREADS)
    torch.set_num_interop_threads(env.THREADS)
    cell = load_cell(args.workload)
    if not torch.cuda.is_available():
        print("perfbench: no CUDA device; the benchmark runs on the card "
              "only", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 3
    print(json.dumps({"perfbench": "env", "workload": args.workload,
                      "seed": args.seed, "seconds": args.seconds,
                      "trace": args.trace, "threads": env.THREADS,
                      "env": fixed, "torch": torch.__version__,
                      "cuda": torch.version.cuda, **card()}),
          file=sys.stderr, flush=True)
    result, judged = run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), device="cuda:0", start=start)
    bad = env.forbidden_modules()
    if bad:
        print(f"perfbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 4
    print(f"perfbench: {args.workload} seed {args.seed}: {judged} "
          f"compared, correct={result['correct']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
