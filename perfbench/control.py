"""The comparison's control: the plain reference put in the program's
place, computed in bfloat16 (the nearest precision below the
configurations' float32), judged exactly as a run judges the program.
It has to come out not correct.

    python3 perfbench/control.py --workload <cell> --seeds 11,22,33 \
        [--program | --fault <name>]

prints, for each seed, one JSON line with every number compared, its
limit, and whether the control was rejected.  For a job cell the
control runs the jobs a run of that seed would compare
(``drivers/job``'s ``check_jobs``); for the score cell it scores, in
bfloat16, the rows of the first ``REQUESTS`` requests of that seed's
traffic (about a run's).  For a job cell, ``--program`` reads the same
numbers of the program itself (those jobs, run untimed after one
set-up), and ``--fault`` those of the program with one of
``faults.FAULTS`` planted: the readings the limits are set from, in one
process.  The benchmark's own runs never run this; it runs on the card,
at the cell's own sizes, and a CPU test runs it at a small size.
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

#: requests the score cell's control scores: about a window's
REQUESTS = 600_000


def control_numbers(cell, seed: int, device, *, requests: int = 0) -> dict:
    """The numbers of the control on ``seed``: each one's worst over the
    jobs (or rows) it compared."""
    import numpy as np
    import torch

    from perfbench.reference import vfl as ref
    from perfbench.reference.data import make_partitions

    parts = make_partitions(cell.config)
    if cell.mix["driver"] == "job":
        from perfbench.drivers.job import check_jobs, job_seed
        worst: dict = {}
        for j in sorted(check_jobs(seed, cell.mix)):
            rec = ref.run_job(parts, cell.config, job_seed(seed, j),
                              cell.mix["variant"], dtype=torch.bfloat16,
                              device=device)
            got = ref.judge_job(rec, parts, cell.config, cell.mix["variant"],
                                device=device)
            for k, v in got.items():
                worst[k] = max(worst.get(k, 0.0), v)
        return worst
    from perfbench.drivers.score import Traffic, make_weights
    mdl = ref.job_settings(cell.config, seed)
    params = make_weights(mdl, parts.feature_dims, seed, device)
    params = ref.params_numpy(params)
    traffic = Traffic(parts.test, cell.mix, ref.n_out(mdl),
                      np.random.default_rng(seed))
    traffic.arrival(requests - 1)
    traffic.next = requests
    idx = traffic.submitted()[0]
    xs = [f[idx] for f in parts.test]
    got = ref.predict(params, mdl["model"], xs, dtype=torch.bfloat16,
                         device=device)
    want = ref.predict(params, mdl["model"], xs, device=device)
    return {"score_missing": 0.0,
            "score_out_gap": float(np.abs(got - want).max())
            / max(1.0, float(np.abs(want).max()))}


def program_numbers(cell, seeds, device, fault=None):
    """(seed, numbers) of the program's own jobs that a run of each seed
    compares, with ``fault`` planted, after one set-up."""
    import copy

    from perfbench import faults
    from perfbench.drivers.job import Driver, check_jobs
    base = Driver(cell, seeds[0], device, False)
    base.setup()
    for seed in seeds:
        drv = copy.copy(base)
        drv.seed, drv.jobs = int(seed), []
        with faults.planted(fault):
            for j in sorted(check_jobs(seed, cell.mix)):
                drv.jobs.append(drv._run(j, capture=True))
        for err in drv.errors():
            print(err, file=sys.stderr)
        yield seed, drv.judge(device)[0]


def rejected(numbers: dict, limits: dict) -> bool:
    return any(numbers.get(k) is None or numbers[k] > v
               for k, v in limits.items())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)
    env.prepare(ROOT)
    import torch

    from perfbench.harness.manifest import cell as load_cell
    torch.set_num_threads(env.THREADS)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    cell = load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    device = torch.device("cuda:0")
    if args.program or args.fault:
        runs = program_numbers(cell, seeds, device, args.fault)
        what = args.fault or "program"
    else:
        runs = ((seed, control_numbers(cell, seed, device,
                                       requests=REQUESTS)) for seed in seeds)
        what = "control"
    for seed, nums in runs:
        print(json.dumps({what: args.workload, "seed": seed,
                          "rejected": rejected(nums, cell.limits),
                          "checks": {k: {"value": nums.get(k), "limit": v}
                                     for k, v in cell.limits.items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
