"""The port's side of ``tests/test_torch_analysis_check.py``'s world
census: a loop program with a collective a step and one outside the
loop, run on every rank of a spawned world
(``repro_torch.launch.mesh.run_ranks``).  Imports the port only."""
from __future__ import annotations

import dataclasses

import torch

STEPS = 3


def loop_census(device):
    """The census of ``rounds`` × ``STEPS`` steps of one all-reduce of 8
    f32 each, after one all-gather of 2 f32 a call; and whether a
    program with one all-reduce a round (not a whole number a step)
    fails the census's assertion."""
    from repro_torch.analysis.census import census_program
    from repro_torch.launch.mesh import make_data_mesh
    from repro_torch.sharding import MeshAxis, all_gather_rows, all_reduce_sum

    axis = MeshAxis(make_data_mesh(), "data")
    t = torch.ones(8, device=device)

    def program(rounds):
        all_gather_rows(torch.ones(2, device=device), axis)
        for _ in range(rounds * STEPS):
            all_reduce_sum(t, axis)

    def per_round(rounds):
        for _ in range(rounds):
            all_reduce_sum(t, axis)

    c = census_program(program, steps=STEPS)
    try:
        census_program(per_round, steps=STEPS)
        whole = None
    except AssertionError as e:
        whole = str(e)
    return dataclasses.asdict(c), whole
