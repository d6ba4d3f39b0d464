"""The port's config mirrors the JAX package's, the port never imports JAX,
and its entry points refuse what this slice has not ported."""
import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from vjf_tpu import config as jcfg
from vjf_tpu_torch import config as tcfg
from vjf_tpu_torch.models import vjf as tcore
from vjf_tpu_torch.ops import fused_step as TF

import torch_tile_plan as TP

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("name", ["VJFConfig", "StepFlags"])
def test_dataclass_fields_and_defaults_match(name):
    j = [(f.name, f.default) for f in dataclasses.fields(getattr(jcfg, name))]
    t = [(f.name, f.default) for f in dataclasses.fields(getattr(tcfg, name))]
    assert t == j


def test_tdtype_and_derived_properties():
    c = tcfg.VJFConfig(ydim=5, xdim=2, udim=1, dtype="float64", n_rbf=7)
    assert c.tdtype == torch.float64
    assert c.feature_dim == 7 and c.xudim == 3
    assert c.replace(dtype="float32").tdtype == torch.float32


_BLOCKED_IMPORT = """
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any import of jax now raises
sys.modules["vjf_tpu"] = None
import vjf_tpu_torch
for m in pkgutil.walk_packages(vjf_tpu_torch.__path__, "vjf_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
assert callable(chip_smoke.main)
print("imported", len(sys.modules))
"""


def test_port_and_chip_smoke_import_without_jax():
    out = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "imported" in out.stdout


def test_chip_smoke_fails_without_a_card():
    """No CUDA here: the script exits non-zero and prints no result line."""
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def _state(cfg):
    return tcore.init_state(0, cfg, device="cpu")


def test_run_epoch_refuses_the_unported_xla_step():
    """The JAX package's XLA step is the port's autograd route: a CPU state
    with ``fused_step='auto'`` (not the fused path) takes it and returns
    finite losses and no tau stream."""
    cfg = tcfg.VJFConfig(ydim=4, xdim=2, n_rbf=5, hidden_sizes=(3,), rls_backend="nsv",
                         fused_step="auto")
    state = _state(cfg)
    assert not TF.fused_enabled(cfg, state)
    assert TF.fused_enabled(cfg.replace(fused_step="on"), state)
    g = torch.Generator().manual_seed(0)
    ys, us = torch.randn(3, 2, 4, generator=g), torch.zeros(3, 2, 0)
    res = tcore.run_epoch(cfg, tcfg.StepFlags(), state, ys, us, 0, 1e-3)
    assert res.metrics.tau is None
    assert torch.isfinite(res.metrics.loss).all() and res.q_means.shape == (3, 2, 2)


_DEFERRED = {
    "mesh": (dict(mesh=object()), "process group"),
    "fit_ensemble_mesh": (dict(mesh=object()), "process group"),
}


@pytest.mark.parametrize("branch", list(_DEFERRED))
def test_deferred_branches_name_their_roadmap_item(branch):
    """``mesh=`` is ported (training over several cards): what is not a dp
    process group raises ``ValueError`` naming it, before any epoch runs."""
    cfg = tcfg.VJFConfig(ydim=4, xdim=2, n_rbf=5, hidden_sizes=(3,), rls_backend="nsv")
    state = _state(cfg)
    ys = torch.zeros(6, 2, 4)
    kw, what = _DEFERRED[branch]
    with pytest.raises(ValueError, match=what):
        if branch == "fit_ensemble_mesh":
            from vjf_tpu_torch.parallel import fit_ensemble

            fit_ensemble(cfg, [state, state], ys, seed=0, max_iter=1, **kw)
        else:
            kw = dict(kw)
            fit_cfg = cfg.replace(**kw.pop("cfg", {}))
            tcore.fit(fit_cfg, state, ys, seed=0, max_iter=1, **kw)


def test_unported_options_raise():
    cfg = tcfg.VJFConfig(ydim=4, xdim=2, n_rbf=5, hidden_sizes=(3,), rls_backend="nsv",
                         fused_step="on")
    st = _state(cfg)
    ys = torch.zeros(3, 2, 4)
    us = torch.zeros(3, 2, 0)
    # the masks are ported: a masked epoch runs (tests/test_torch_masks.py)
    res = tcore.run_epoch(cfg, tcfg.StepFlags(), st, ys, us, 0, 1e-3, mask=torch.ones(3, 2))
    assert torch.isfinite(res.metrics.loss).all()
    # the other regression backends are ported (tests/test_torch_regression.py)
    pst = tcore.init_state(0, cfg.replace(rls_backend="precision"), device="cpu")
    assert type(pst.dynamics.blr).__name__ == "PrecisionBLR"


def test_kernel_wrapper_rejects_cpu_tensors():
    """The CUDA launch path takes device tensors only; it never falls back."""
    cfg = tcfg.VJFConfig(ydim=4, xdim=2, n_rbf=5, hidden_sizes=(3,), rls_backend="nsv",
                         fused_step="on")
    carry = TF.pad_carry(cfg, _state(cfg))
    q = torch.zeros(2, 2)
    with pytest.raises(ValueError, match="expected a tensor on"):
        TF._launch("fused_step", cfg, tcfg.StepFlags(), carry, q, q, torch.zeros(1, 2, 4),
                   None, None, None, torch.tensor(1e-3), torch.empty(2, 2, 2),
                   torch.empty(1, 8))


class _StagingLib:
    """The kernels' two size queries, without a build, answered by the
    mirror of their tile plan (``tests/torch_tile_plan.py``), which counts
    the staging of a trial mask's row and a tile's channel mask rows; it
    records each query and its answer."""

    def __init__(self):
        self.seen, self.answers = [], []

    def vjf_smem_bytes(self, args):
        a = args._obj
        self.seen.append((bool(a.mask), bool(a.cmask)))
        self.answers.append(TP.plan_of(a).smem_bytes)
        return self.answers[-1]

    def vjf_smem_limit(self):
        return 232448


def test_kernel_limits_count_the_mask_staging(monkeypatch, caplog):
    """``kernel_limits`` asks the library with the mask operands set, and
    under 'auto' only an epoch whose staging is past the card takes the
    autograd route. The flagship widths at 256 padded features and 256
    trials, which the channel mask's two buffers once put past the card, now
    take the L2 route with it (sub-panels, the trials' state in L2); at
    ydim 2500 the unmasked and trial-masked epochs fit at a tile of 4 trials
    a block on that route, the channel-masked one not even at the smallest
    plan."""
    import logging

    lib = _StagingLib()
    monkeypatch.setattr(TF, "_on_cuda", lambda t: True)
    monkeypatch.setattr(TF, "_routed_away", set())
    monkeypatch.setattr(TF, "_library", lambda: lib)
    cfg = tcfg.VJFConfig(ydim=200, xdim=10, n_rbf=200, hidden_sizes=(32,), rls_backend="nsv",
                         dtype="float32")
    for kw in ({}, {"mask": True}, {"channel_mask": True}):
        assert TF.kernel_limits(cfg, 256, **kw) is None
    assert lib.seen == [(False, False), (True, False), (False, True)]
    assert max(lib.answers) <= 232448
    assert TP.tile_plan(cfg, 256).sp == 0 and TP.tile_plan(cfg, 256, channel_mask=True).sp == 16
    wide = cfg.replace(ydim=2500)
    lib.seen, lib.answers = [], []
    assert TF.kernel_limits(wide, 256) is None
    assert TF.kernel_limits(wide, 256, mask=True) is None
    reason = TF.kernel_limits(wide, 256, channel_mask=True)
    assert lib.seen == [(False, False), (True, False), (False, True)]
    assert lib.answers[0] <= lib.answers[1] <= 232448 < lib.answers[2]
    assert reason is not None and "channel mask" in reason and str(lib.answers[2]) in reason
    # the plan behind the refusal: the smallest tile, chunk and sub-panel
    assert TP.tile_plan(wide, 256, channel_mask=True)[:2] == (4, 4)
    st = _state(wide)
    with caplog.at_level(logging.WARNING, logger=TF.__name__):
        assert TF.fused_enabled(wide, st, n_batch=256, mask=True)
        assert not TF.fused_enabled(wide, st, n_batch=256, mask=True, channel_mask=True)
    assert any("channel mask" in r.getMessage() for r in caplog.records)
