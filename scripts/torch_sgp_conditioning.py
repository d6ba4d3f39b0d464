"""Why ``chip_smoke.py`` holds the SGP kernels against their plain versions
from ``sgp_check_state`` and not from the bootstrap's own posterior.

    python3 scripts/torch_sgp_conditioning.py [--device cpu]

At the SGP flagship (``chip_smoke.sgp_flagship``: B 256, ydim 200, xdim 10,
``n_inducing`` 100, f32 products) two states are built
from the same 256-step warm-up epoch and bootstrap:

* ``bootstrap``: the bootstrap's posterior (its precision at the floor of
  ``one_shot_rls``'s eigh), then 128 plain exact-prefix steps;
* ``check``: ``chip_smoke.sgp_check_state``, the bootstrap's inducing
  points, whitener and state noise with the weight posterior N(0, I / c).

From each, 64 mega steps run in the plain version in float32 and in
float64, and ``chip_smoke.compare``'s normalised error of the f32 run
against the f64 one is printed by leaf: where it is about 1, the f32
algorithm does not determine the leaf, and a kernel cannot be held to it.
On a card, the kernel against the plain version from the same state is
printed beside it. One JSON line per state, with the condition number of
the precision and the mega segment's tau; the device's name (and on a card
its power limit). Needs nvcc on a card.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def _double(carry):
    return carry._replace(**{
        k: (v.double() if isinstance(v, torch.Tensor) and v.is_floating_point()
            else tuple(x.double() for x in v) if isinstance(v, tuple) else v)
        for k, v in carry._asdict().items()})


def main(argv) -> int:
    import chip_smoke as cs
    from vjf_tpu_torch.config import StepFlags
    from vjf_tpu_torch.models import vjf as core
    from vjf_tpu_torch.ops import fused_step as F

    on_card = "--device" not in argv or argv[argv.index("--device") + 1] != "cpu"
    if on_card and not torch.cuda.is_available():
        print("torch_sgp_conditioning: no CUDA device (pass --device cpu)", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0" if on_card else "cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    errors = {}

    def record(name, **fields):       # compare's phase line, kept by name
        errors[name] = fields["err_by_leaf"]

    cs.phase = record
    cs.check = lambda ok, what: None  # the readings are the result here
    cfg = cs.sgp_flagship("float32")
    b = cs.B
    ys = cs.spikes(512, b, cfg.ydim, dev, seed=1)
    us = torch.zeros((512, b, 0), device=dev)
    lr = torch.tensor(cfg.lr, device=dev)
    eps = torch.randn((2, 512, b, cfg.xdim), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(2))
    flags = StepFlags()
    check_state, qm, qlv = cs.sgp_check_state(cfg, ys, us, lr)
    warm = core.run_epoch(cfg, StepFlags(warm_up=True), core.init_state(0, cfg, device=dev),
                          ys[:cs.WARM_STEPS], us[:cs.WARM_STEPS], 5, lr)
    boot = core._bootstrap_dynamics(cfg, warm.state, warm.q_means, us[:cs.WARM_STEPS],
                                    torch.Generator().manual_seed(3))
    carry = F.pad_carry(cfg, boot)
    bq = (qm, qlv)
    for t in range(128):
        out = cs.prefix_step(F.fused_step_plain, cfg, flags, carry, *bq, ys[t], eps[0, t],
                             eps[1, t], lr)
        carry, bq = out.carry, (out.q_pack[0], out.q_pack[1])
    states = {"bootstrap": (carry, bq, 128), "check": (F.pad_carry(cfg, check_state),
                                                      (qm, qlv), cs.WARM_STEPS)}
    smi = cs.smi_line() if on_card else "cpu"
    for name, (c, (m, lv), lo) in states.items():
        hi = lo + cs.MEGA_STEPS
        args = (m, lv, ys[lo:hi], None, eps[0, lo:hi], eps[1, lo:hi], lr)
        start = {k: v.double() for k, v in cs.flatten(c._asdict()).items()}
        r32 = F.mega_epoch_plain(cfg, flags, cs.clone(c), *args)
        a64 = tuple(x.double() if isinstance(x, torch.Tensor) else x for x in args)
        r64 = F.mega_epoch_plain(cfg.replace(dtype="float64"), flags, _double(cs.clone(c)),
                                 *a64)
        cs.compare("f32_vs_f64", cs.segment(*r64),
                   {k: v.double() for k, v in cs.segment(*r32).items()}, 1e-3, start)
        line = {"state": name, "steps": cs.MEGA_STEPS, "device": smi,
                "precision_cond": float(torch.linalg.cond(
                    c.p_mat[:cfg.n_inducing, :cfg.n_inducing].double())),
                "tau_first_max": [float(r32[2][0, 4]), float(r32[2][:, 4].max())],
                "f32_vs_f64": errors["f32_vs_f64"]}
        if on_card:
            k = F.mega_epoch_call(cfg, flags, cs.clone(c), *args)
            cs.compare("kernel_vs_plain", cs.segment(*r32), cs.segment(*k), 1e-3,
                       cs.flatten(c._asdict()))
            line["kernel_vs_plain"] = errors["kernel_vs_plain"]
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
