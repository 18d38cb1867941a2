"""The control: the program's own float32 path put in place of the
float64 solve each cell states (``benchmark.calibrate --control``: the
configuration and the solves in float32), judged by the cell's own
limits, comes out not correct on every seed (at toy sizes here; its
readings at the cells' own sizes on the card are in PERF.md), and reads
the apply's number above its limit too. And the float64 runs of the
same seeds come out correct."""

import json
from pathlib import Path

import pytest

from benchmark import reference
from benchmark.tests import toy

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEEDS = (2**31 + 21, 2**31 + 22, 2**31 + 23)


@pytest.mark.parametrize("workload", CELLS + [toy.FOUR])
def test_control_fails_and_the_program_passes(workload, tmp_path):
    root = toy.four_rank_root(tmp_path) if workload == toy.FOUR else ROOT
    seeds = SEEDS[:1] if workload == toy.FOUR else SEEDS
    cell, control = toy.calibrate(workload, seeds, control=True, root=root)
    assert cell.params["dtype"] == "float32"
    for row in control:
        ok, checks = reference.judge(row, cell.limits, 0)
        assert not ok, checks
        # float32 rounding alone reads ten times the stated tolerance.
        assert row["residual"] > 10 * cell.limits["residual"]
        assert row["apply_gap"] > 10 * cell.limits["apply_gap"]
    cell, program = toy.calibrate(workload, seeds, control=False, root=root)
    for row in program:
        ok, checks = reference.judge(row, cell.limits,
                                     0 if row["converged"] else 1)
        assert ok, checks
