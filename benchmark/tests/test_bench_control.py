"""The check's control at a size a test run holds: the reference itself in
the program's place, its products one precision below the configuration's
(fp8 for bf16), reads ``q_gap`` above each cell's limit; the reference at
the configuration's precision reads 0 against itself. At the cells' own
size on the card, ``control.py`` gives the readings the limits were set
from (PERF.md)."""
import pytest
import torch

from bench_tiny import tiny

import check
import gen
from reference import plain

CELLS = ["flagship.prefix_free", "flagship.train_b1024"]


@pytest.mark.parametrize("workload", CELLS)
def test_fp8_control_fails_the_check(workload):
    cell = tiny(workload)
    tr = dict(cell.traffic, steps=96)
    ys = gen.make(tr, cell.model["ydim"], 3, "cpu")
    start = plain.init_state(cell.model, 8, "cpu")
    flags = {"sgd": True, "update": True, "warm_up": False}
    args = (cell.model, flags, start, ys, 4, cell.model["lr"], tr["prefix"], 96)
    with torch.no_grad():
        ref, _, _ = plain.follow(*args, "bfloat16")
        low, _, _ = plain.follow(*args, "fp8")
    limit = cell.traffic["limits"]["q_gap"]
    assert check.q_gap(ref[:, 0], ref[:, 1], ref) == 0.0
    assert check.q_gap(low[:, 0], low[:, 1], ref) > limit
