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
    "mesh": (dict(mesh=object()), "item 13"),
    "mask": (dict(mask=torch.ones(6, 2)), "item 8"),
    "channel_mask": (dict(channel_mask=torch.ones(6, 2, 4)), "item 8"),
    "checkpoint_path": (dict(checkpoint_path="fit.ckpt", checkpoint_every=1), "item 10"),
    "resume_from": (dict(resume_from="fit.ckpt"), "item 10"),
    "multistep_refine": (dict(cfg=dict(multistep_refine=2)), "item 7"),
    "sgp": (dict(cfg=dict(dynamics="sgp")), "item 9"),
    "kalman": (dict(cfg=dict(dynamics_update="kalman")), "item 3"),
    "warm_gate": (None, "item 11"),
    "precision_backend": (None, "item 3"),
    "covariance_backend": (None, "item 3"),
}


@pytest.mark.parametrize("branch", list(_DEFERRED))
def test_deferred_branches_name_their_roadmap_item(branch):
    """Each branch this slice leaves out raises NotImplementedError naming
    the ROADMAP Queue 1 item that will port it."""
    cfg = tcfg.VJFConfig(ydim=4, xdim=2, n_rbf=5, hidden_sizes=(3,), rls_backend="nsv")
    state = _state(cfg)
    ys = torch.zeros(6, 2, 4)
    kw, item = _DEFERRED[branch]
    with pytest.raises(NotImplementedError, match=f"Queue 1 {item}$|Queue 1 {item}[^0-9]"):
        if branch == "warm_gate":
            tcore.run_epoch(cfg, tcfg.StepFlags(), state, ys, torch.zeros(6, 2, 0), 0, 1e-3,
                            warm_gate=torch.tensor(1.0))
        elif branch.endswith("_backend"):
            tcore.init_state(0, cfg.replace(rls_backend=branch.split("_")[0]), device="cpu")
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
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        tcore.run_epoch(cfg, tcfg.StepFlags(), st, ys, us, 0, 1e-3, mask=torch.ones(3, 2))
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        TF.fused_enabled(cfg.replace(dynamics="sgp"), st)
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        tcore.init_state(0, cfg.replace(rls_backend="precision"), device="cpu")


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
