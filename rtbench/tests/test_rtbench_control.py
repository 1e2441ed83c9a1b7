"""The control, the reference computed in bfloat16 in the program's
place, comes out not correct against each cell's limits; the float32
reference in its place comes out exact. At a tiny size on the CPU, and,
on a card, at the cell's own size."""

from __future__ import annotations

import pytest
import torch

from rtbench import check, readings, run

CELLS = ("config4.closeup", "reference.wide", "config4.wide", "reference.closeup")


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_the_limits(tiny_cell, workload):
    cell = tiny_cell(workload)
    seed = 2**32 + 21
    out = run.run_cell(cell, seed, 0.0, False, "cpu", log=lambda m: None)
    exact = readings.control_numbers(cell, seed, out["check"], "cpu", torch.float32)
    assert exact == {"over_share": 0.0, "gap_mean": 0.0}
    low = readings.control_numbers(cell, seed, out["check"], "cpu", torch.bfloat16)
    assert not check.passed(check.judge(low, cell.limits["limits"])), low


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_at_the_cells_size(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a card: the cell's own size")
    from rtbench import manifest

    cell = manifest.Cell(manifest.load(), workload)
    seed = 2**33 + 5
    out = run.run_cell(cell, seed, 0.0, False, "cuda", log=lambda m: None)
    assert out["result"]["correct"], out["result"]["check"]
    low = readings.control_numbers(cell, seed, out["check"], "cuda", torch.bfloat16)
    assert not check.passed(check.judge(low, cell.limits["limits"])), low
