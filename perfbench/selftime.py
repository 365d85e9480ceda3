"""Where a job cell's host time goes, span by span, and what tracing
costs: jobs of the cell back to back, traced and untraced in turns on
the same job seeds (the order alternating from job to job).

    python3 perfbench/selftime.py --workload yp-linreg.treecss --seed 7 \
        --jobs 10

prints one JSON line: the median job wall traced and untraced, the
median and quartiles of each job's traced-over-untraced ratio, the spans
of a traced job, and, over the traced jobs, the mean ms a job of every
span name's summed wall (``span_ms``) and of its self time, the wall
less its child spans' (``self_ms``), largest first.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.harness import env  # noqa: E402  (stdlib only)


def self_times(cell, seed: int, jobs: int, device) -> dict:
    """The module docstring's numbers for ``jobs`` pairs of jobs."""
    from perfbench.drivers.job import Driver
    drv = Driver(cell, seed, device, False)
    drv.setup()
    walls = {False: [], True: []}
    span_s, self_s, n_spans = {}, {}, []
    for j in range(1, jobs + 1):
        for traced in ((False, True) if j % 2 else (True, False)):
            drv.trace = traced
            r = drv._run(j)
            if r.error:
                raise RuntimeError(r.error)
            walls[traced].append(r.t1 - r.t0)
            if not traced:
                continue
            spans = r.info.spans
            n_spans.append(len(spans))
            kids = {}
            for s in spans:
                kids[s.parent] = kids.get(s.parent, 0.0) + s.duration
            for s in spans:
                span_s[s.name] = span_s.get(s.name, 0.0) + s.duration
                self_s[s.name] = (self_s.get(s.name, 0.0) + s.duration
                                  - kids.get(s.sid, 0.0))
    ratios = [t / u for u, t in zip(walls[False], walls[True])]
    per_job = lambda d: {k: 1e3 * v / jobs for k, v in
                         sorted(d.items(), key=lambda kv: -kv[1])}
    return {"jobs": jobs,
            "untraced_median_s": statistics.median(walls[False]),
            "traced_median_s": statistics.median(walls[True]),
            "ratio_median": statistics.median(ratios),
            "ratio_quartiles": (statistics.quantiles(ratios, n=4)
                                if jobs > 1 else ratios * 3),
            "spans_a_job": statistics.median(n_spans),
            "span_ms": per_job(span_s), "self_ms": per_job(self_s)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--jobs", type=int, required=True)
    args = ap.parse_args(argv)
    env.prepare(ROOT)
    import torch

    from perfbench.harness.manifest import cell as load_cell
    torch.set_num_threads(env.THREADS)
    torch.set_num_interop_threads(env.THREADS)
    if not torch.cuda.is_available():
        print("selftime: no CUDA device", file=sys.stderr)
        return 3
    print(json.dumps(self_times(load_cell(args.workload), args.seed,
                                args.jobs, torch.device("cuda:0"))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
