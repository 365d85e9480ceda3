"""On the card (``-m card``; skipped without one): every cell, at its
own size, runs correct for a few seconds, and its control comes out not
correct."""
from __future__ import annotations

import time

import pytest

from perfbench import control
from perfbench.harness.manifest import load_manifest
from perfbench.run import run_cell

CELLS = [w["name"] for w in load_manifest()["workloads"]]
SEED = 2 ** 31 + 777


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_card(card, name):
    from perfbench.harness.manifest import cell
    result, judged = run_cell(cell(name), SEED, 3.0, False, device=card,
                              start=time.time())
    assert judged >= 1 and result["correct"], result["checks"]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_on_card(card, name):
    from perfbench.harness.manifest import cell
    c = cell(name)
    nums = control.control_numbers(c, SEED, card,
                                   requests=control.REQUESTS)
    assert control.rejected(nums, c.limits), nums
