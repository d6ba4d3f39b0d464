"""The readings that the check's limits are set from, on the card, at a
cell's own size:

    python3 benchmark/control.py --workload <name> --seeds <n> [<n> ...] [--control] [--faults]

For each seed: the run's set-up, one timed call and the check, as
``run.py`` makes them (the sound program); with ``--control`` the control, the reference
itself in the program's place with its products in fp8 (e4m3, one scale an
operand: the next precision below the configuration's bf16), read as the
gap of its posteriors from the reference's over the steps the check
follows; with ``--faults``, one timed call under each planted fault of
``faults.py`` and its check. One JSON line per reading; none of this is
part of a benchmark run."""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))

import torch  # noqa: E402

import cells  # noqa: E402
import check  # noqa: E402
import faults  # noqa: E402
import run  # noqa: E402
from reference import plain  # noqa: E402


def control_gap(model, stage, ys) -> float:
    """The fp8 reference's posteriors against the reference's over the
    steps the check follows."""
    start = stage["start"] or plain.init_state(model, stage["init_seed"], ys.device)
    args = (model, stage["flags"], start, ys[:stage["steps"]], stage["seed"], stage["lr"],
            stage["prefix"], stage["follow"])
    ref, _, _ = plain.follow(*args, "bfloat16")
    low, _, _ = plain.follow(*args, "fp8")
    return check.q_gap(low[:, 0], low[:, 1], ref)


def readings(cell, seed: int, dev, with_faults: bool, with_control: bool = True):
    """The readings of one seed, as dicts: the sound program, with
    ``with_control`` the control, with ``with_faults`` each planted fault."""
    tr = cell.traffic
    t0 = time.perf_counter()
    s = run.seeds(seed)
    cfg, ys, us, warmed, stages = run.set_up(cell, s, dev)
    with check.no_tf32(), torch.no_grad():
        setup_gaps = [check.stage_gaps(cell.model, st, ys[:st["steps"]]) for st in stages]
        ctrl = [control_gap(cell.model, st, ys) for st in stages] if with_control else []
    for name in ("sound",) + (faults.NAMES if with_faults else ()):
        s["calls"] = run.seeds(seed)["calls"]
        with faults.planted(name) if name != "sound" else contextlib.nullcontext():
            out = run.window(cfg, tr, warmed, ys, us, s, dev, calls=1)
        res, call_seed = out[3]
        fails = run.gate_failures(out[2])
        stage = run.call_stage(cfg, tr, warmed, res, call_seed)
        t_check = time.perf_counter()
        with check.no_tf32(), torch.no_grad():
            g = check.stage_gaps(cell.model, stage, ys)
            g["check_s"] = time.perf_counter() - t_check
            if name == "sound" and with_control:
                ctrl.append(control_gap(cell.model, stage, ys))
        del res, out, stage
        nums = {k: max([g.get(k, 0.0)] + [sg.get(k, 0.0) for sg in setup_gaps]) for k in g
                if k != "check_s"}
        yield {"workload": cell.name, "seed": seed, "variant": name,
               "gate_failures": fails, **nums, "by_stage": setup_gaps + [g]}
        if name == "sound" and with_control:
            yield {"workload": cell.name, "seed": seed, "variant": "control_fp8",
                   "q_gap": max(ctrl), "by_stage": ctrl}
    yield {"workload": cell.name, "seed": seed, "seconds": time.perf_counter() - t0}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args()
    cell = cells.load(args.workload)
    for seed in args.seeds:
        for line in readings(cell, seed, torch.device("cuda", 0), args.faults, args.control):
            print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
