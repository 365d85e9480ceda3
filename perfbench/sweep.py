"""The rates a serving mix sustains on this card: a sweep of offered
loads, to fix a mix's ``offered_rows_per_s`` once (the runs themselves
offer a fixed rate and never search for one).

    python3 perfbench/sweep.py --workload hi-mlp.score --seed 7 \
        --seconds 10 --rates 10000,20000,40000

prints, for each rate, one JSON line: the rows a second offered and
returned in the window, the latency's median and 95th percentile, the
rows still queued at the window's close and the seconds their drain
took.  A rate is sustained where the rows returned keep up with the rows
offered and nothing is left queued.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.harness import env  # noqa: E402  (stdlib only)


def sweep(cell, seed: int, seconds: float, rates, device):
    """One dict a rate, as the module docstring says."""
    import numpy as np

    from perfbench.harness.manifest import load_module
    mix = cell.mix
    for rate in rates:
        cell.mix = dict(mix, offered_rows_per_s=rate)
        drv = load_module("drivers", mix["driver"]).Driver(
            cell, seed, device, False)
        drv.setup()
        drv.window(seconds)
        _, _, counts, ok, lat = drv.traffic.submitted()
        window_s = drv.t1 - drv.t0
        yield {"offered_rows_per_s": rate,
               "submitted_rows_per_s": float(counts.sum()) / window_s,
               "score_rows_per_s": drv.rows_done / window_s,
               "p50_ms": 1e3 * float(np.nanpercentile(lat, 50)),
               "p95_ms": 1e3 * float(np.nanpercentile(lat, 95)),
               "backlog_rows_at_close": drv.backlog_rows,
               "drain_s": drv.drain_s, "returned_whole": bool(ok.all())}
    cell.mix = mix


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    env.prepare(ROOT)
    import torch

    from perfbench.harness.manifest import cell as load_cell
    torch.set_num_threads(env.THREADS)
    if not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 3
    rates = [float(r) for r in args.rates.split(",")]
    for row in sweep(load_cell(args.workload), args.seed, args.seconds,
                     rates, torch.device("cuda:0")):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
