"""On the card: each cell's control (the plain reference computed in the
precision below the configuration's, in the program's place) fails the
cell's check, and the program passes it, at the cell's widths with a short
window. Run there with `python -m pytest portbench/tests -m card`."""

import dataclasses
import time

import pytest
import torch

from portbench import harness as H

# a size a test run holds: the cell's widths and depth, fewer rows
SMALLER = {"embed": dict(check_rows=64, pool_batches=2), "train": dict(pool_batches=3)}


@pytest.mark.card
@pytest.mark.parametrize("name", [w["name"] for w in H.manifest()["workloads"]])
def test_control_fails_and_program_passes(card, name):
    cell = H.cell(name)
    cell = dataclasses.replace(cell, traffic=dict(cell.traffic,
                                                  **SMALLER[cell.traffic["kind"]]))
    limits = cell.traffic["limits"]
    run = H.kind_module(cell.traffic["kind"]).Run(cell, 2**31 + 99, card,
                                             H.SetupClock(time.perf_counter()))
    run.execute(0.5)
    got = run.readings()
    run.free_program()
    want = run.reference("fp32")
    program = run.compare(got, want)
    control = run.compare(run.reference(cell.traffic["control"]), want)
    torch.cuda.empty_cache()
    assert all(program[k] <= limits[k] for k in limits), program
    assert any(control[k] > limits[k] for k in limits), control
