"""Configuration tree, mirrored field for field from ``vjf_tpu/config.py``.

The JAX package's config module imports ``jax.numpy`` for its dtype map, so
the port keeps its own copy: same field names, same defaults, same order.
``tdtype`` replaces ``jdtype``. The comments on each knob live in the JAX
file; a test pins the two dataclasses equal. Unlike the JAX package,
``VJFConfig`` rejects an ``ns_prefix_free`` other than 'auto' or 'off'.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Tuple

import torch

_DTYPES = {
    "float32": torch.float32,
    "float64": torch.float64,
    "bfloat16": torch.bfloat16,
}


@dataclass(frozen=True)
class VJFConfig:
    """Static model + training configuration (hashable)."""

    # --- architecture ---
    ydim: int
    xdim: int
    udim: int = 0
    n_rbf: int = 100
    hidden_sizes: Tuple[int, ...] = (20,)
    likelihood: str = "gaussian"          # 'gaussian' | 'poisson'
    dynamics: str = "rbf"                 # 'rbf' | 'sgp'
    recognition_activation: str = "tanh"  # the fused kernels support tanh only

    # --- optimizer ---
    lr: float = 1e-4
    lr_decay: float = 0.9
    clip: float = 1.0

    # --- constants of the reference, made explicit ---
    poisson_clamp: float = 10.0
    obs_var_cap: int = 1000
    state_var_cap: int = 500
    centroid_init_range: float = 2.0
    init_obs_logvar: float = math.log(0.1)
    rls_shrink: float = 1.0
    leak: float = 0.0
    dynamics_update: str = "rls"          # 'rls' | 'kalman'
    kalman_diffusion: float = 0.01
    joseph_quirk: bool = False

    # --- fit loop ---
    beta: float = 0.1
    rtol: float = 1e-4
    warmup_max: int = 0
    logvar_clamp: float = 30.0

    # --- forecast-skill training (deprecated in the JAX package) ---
    multistep_refine: int = 0
    multistep_weight: float = 0.3
    multistep_iters: int = 2

    # --- forecast-gated model selection ---
    select: str = "loss"
    select_horizon: int = 20
    select_starts: int = 32

    # --- accelerator knobs ---
    sync_every: int = 1
    sync_trust: float = 0.25
    rls_backend: str = "auto"             # 'precision' | 'covariance' | 'nsv' | 'auto'
    fused_step: str = "auto"              # whole-step kernel: 'on' | 'off' | 'auto'
    fused_epoch: str = "mega"             # 'mega' | 'stepwise'
    ns_prefix: int = 512
    ns_prefix_free: str = "auto"
    mega_ns_iters: int = 0
    matmul_dtype: str = "bfloat16"
    trace_quirk: bool = True
    dtype: str = "float32"
    chol_jitter: float = 0.0
    n_inducing: int = 50
    sgp_scale: float = 1.0
    sgp_lengthscale: float = 1.0
    sgp_adapt_lr: float = 0.0
    sgp_adapt_steps: int = 5
    demote_hot_frac: float = 0.01
    repromote_after: int = 3
    repromote_max: int = 8
    stop_patience: int = 1
    rls_epoch_repair: str = "auto"
    sgp_fused_min_batch: int = 8

    def __post_init__(self):
        # deliberate deviation: the JAX package reads any value other than
        # 'off' as 'auto', so a typo passes silently
        if self.ns_prefix_free not in ("auto", "off"):
            raise ValueError(
                f"ns_prefix_free must be 'auto' or 'off' (got {self.ns_prefix_free!r})"
            )

    @property
    def tdtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def feature_dim(self) -> int:
        return self.n_rbf if self.dynamics == "rbf" else self.n_inducing

    @property
    def xudim(self) -> int:
        return self.xdim + self.udim

    def replace(self, **kw) -> "VJFConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class StepFlags:
    """Static per-call flags of one filter-then-learn step.

    ``warm_up`` excludes the dynamics loss and skips the RLS update;
    ``train_decoder`` is the fit loop's post-warm-up decoder freeze;
    ``update_likelihood``/``update_transition`` toggle the two
    non-gradient updates, both of which also need ``update=True``.
    """

    sgd: bool = True
    update: bool = True
    warm_up: bool = False
    train_decoder: bool = True
    update_likelihood: bool = True
    update_transition: bool = True
