"""Settings of the benchmark's own tests (``python -m pytest
perfbench/tests`` from the repository root).

Tests marked ``card`` need a CUDA card: the ``card`` fixture decides, at
run time, and skips them with a reason where there is none.  The
``tiny`` fixture gives a cell of ``BENCHMARK.json`` cut to a size the
CPU runs in seconds, for the drivers' and the comparison's tests, which
run the program's plain versions on the CPU (the program's choice
there).
"""
from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

#: rows of the data set a tiny cell makes, by configuration
TINY_ROWS = {"hi-mlp": 3000, "yp-linreg": 6000}
#: the cells of ``BENCHMARK.json``
CELLS = [w["name"] for w in __import__("json").loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skipped without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run `python -m pytest "
                    "perfbench/tests -m card` on the chip")
    return torch.device("cuda:0")


#: (unit, name) of the metrics a cell that ``BENCHMARK.json`` does not
#: hold reports, by its mix's driver: (end to end, per layer)
FILES_METRICS = {
    "job": ([("s", "setup_s"), ("s", "job_s")],
            [("ms", "align_ms"), ("ms", "train_step_ms"), ("ms", "eval_ms"),
             ("%", "train_mfu"), ("%", "bottom_roofline.job"),
             ("%", "idle_share.job")]),
    "score": ([("s", "setup_s"), ("rows/s", "score_rows_per_s")],
              [("ms", "score_dispatch_ms"), ("ms", "score_p95_ms"),
               ("%", "score_mfu"), ("%", "bottom_roofline.score"),
               ("%", "idle_share.score")]),
}


def files_cell(name: str):
    """A cell that ``BENCHMARK.json`` does not hold but whose files are
    there (``<config>.<traffic>``: its configuration, mix, limits and
    metric readers)."""
    import json

    from perfbench.harness.manifest import PERFBENCH, Cell
    config, traffic = name.split(".")
    load = lambda *p: json.loads(PERFBENCH.joinpath(*p).read_text())
    mix = load("mixes", f"{traffic}.json")
    e2e, layer = ([{"name": n, "unit": u} for u, n in group]
                  for group in FILES_METRICS[mix["driver"]])
    return Cell(name=name, config=load("configs", f"{config}.json"),
                mix=mix, limits=load("limits", f"{name}.json"), chips=1,
                end_to_end=e2e, per_layer=layer)


@pytest.fixture
def tiny():
    """``tiny(name)``: the cell ``name`` at ``TINY_ROWS`` rows, at most
    3 epochs, and requests offered at 2,000 rows a second for the score
    mix."""
    from perfbench.harness.manifest import cell

    def make(name: str):
        c = cell(name) if name in CELLS else files_cell(name)
        c.config = copy.deepcopy(c.config)
        c.config["dataset"]["n_instances"] = TINY_ROWS[c.config["name"]]
        c.config["model"]["max_epochs"] = 3
        if c.mix["driver"] == "score":
            c.mix = dict(c.mix, offered_rows_per_s=2000,
                         profile_after_rounds=2, profile_rounds=2)
        return c
    return make
