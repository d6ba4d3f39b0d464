"""One short run of each cell on the card, as the benchmark's command runs
it: ``pytest -m card benchmark/tests`` on a machine with an NVIDIA GPU.
Skips elsewhere."""
import json
import subprocess
import sys

import pytest

from bench_tiny import ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.card
@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_cell_runs_correct_on_the_card(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", workload,
                          "--seed", "3141592653", "--seconds", "2", "--trace", "0"],
                         capture_output=True, text=True, cwd=str(ROOT), timeout=1500)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["failed"] == 0 and res["device"]["platform"] == "gpu"


@pytest.mark.card
def test_teacher_forced_graph_is_eager():
    """The teacher-forced reference's CUDA graph replays the eager steps:
    the same gap and the same end state, bit for bit, at the flagship's
    widths over a prefix and a segment."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import cells
    import gen
    from reference import plain

    cell = cells.load("flagship.train_b1024")
    dev = torch.device("cuda", 0)
    b, t_len = 256, 40
    ys = gen.make(dict(cell.traffic, trials=b, steps=t_len), cell.model["ydim"], 5, dev)
    st = plain.init_state(cell.model, 6, dev)
    g = torch.Generator(device=dev).manual_seed(7)
    qm = 0.3 * torch.randn((t_len, b, cell.model["xdim"]), generator=g, device=dev)
    qlv = -1.0 + 0.1 * torch.randn((t_len, b, cell.model["xdim"]), generator=g, device=dev)
    flags = {"sgd": True, "update": True, "warm_up": False}
    out = [plain.teacher_forced(cell.model, flags, st, ys, qm, qlv, 9, 1e-4, 8, "bfloat16",
                                chunk=16, graph=graph) for graph in (False, True)]
    assert out[0][0] == out[1][0] > 0
    for key in ("w_dyn", "precision", "cov", "state_logvar"):
        assert torch.equal(out[0][1][key], out[1][1][key]), key
    for key, v in plain.sgd_leaves(out[0][1]).items():
        assert torch.equal(v, plain.sgd_leaves(out[1][1])[key]), key


def test_run_refuses_without_enough_cards():
    """Without a CUDA device (or too few) the run exits non-zero and prints
    no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          SPEC["workloads"][0]["name"], "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, cwd=str(ROOT), timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
