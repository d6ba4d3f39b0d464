"""VJF orchestrator: state, the autograd step, epochs and the fit loop
(counterpart of ``vjf_tpu/models/vjf.py``).

``run_epoch`` sends an epoch through the fused kernels
(``ops.fused_step.run_epoch_fused``) where ``fused_enabled`` says so, and
otherwise through :func:`filter_step`, the whole step as plain tensor code
with torch autograd, one Python call per timestep. The multi-rank route is
``parallel.sharded.run_epoch_fused_sharded``. :func:`fit` is the host-side
training loop: warm-up, the plateau that freezes the decoder and
bootstraps the dynamics, RLS epochs, hot-tau demotion to the autograd
epoch, convergence, ``select='forecast'``, and in blocked mode
(:func:`_fit_blocked`) prefix-free continuation. ``init_state`` builds the
model on the card unless the caller asks for ``device="cpu"``; the other
entry points run wherever the state lives. Where the JAX package takes a
PRNG key, the port takes an int seed or a CPU ``torch.Generator``.
"""
from __future__ import annotations

import logging
import math
from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from ..config import StepFlags, VJFConfig
from ..ops import fused_step as _fused
from ..ops.functional import finite_or_zero, gaussian_entropy, reparametrize
from ..types import Gaussian
from . import dynamics as dyn
from .decoder import decode, init_decoder
from .likelihoods import (
    GaussianLikParams,
    gaussian_lik_update,
    gaussian_nll,
    init_gaussian_lik,
    init_poisson_lik,
    poisson_nll,
)
from .recognition import Recognition, init_recognition, linear_from, map_linears

logger = logging.getLogger(__name__)

_MESH_TODO = "fit(mesh=...): ROADMAP Queue 1 item 13"
_SNAPSHOT_TODO = "FitSnapshot checkpoints and resume: ROADMAP Queue 1 item 10"
_MULTISTEP_TODO = "multistep_refine: ROADMAP Queue 1 item 7"
_WARM_GATE_TODO = "warm_gate (phase-mixed ensemble epochs): ROADMAP Queue 1 item 11"


class PriorParams(NamedTuple):
    """Initial-state prior: never trained, stays at zero."""

    mean: torch.Tensor     # (xdim,)
    logvar: torch.Tensor   # (xdim,)


class Params(NamedTuple):
    """The gradient-trained parameters (SGD + value clip)."""

    recognition: Recognition
    decoder: nn.Linear
    likelihood: object            # GaussianLikParams | PoissonLikParams
    prior: PriorParams


class TrainState(NamedTuple):
    """Everything that evolves during training."""

    params: Params
    dynamics: dyn.DynamicsState
    lik_n_sample: torch.Tensor    # float counter


class Metrics(NamedTuple):
    """Per-step ELBO components (recon/dynamics/entropy are ELBO terms, loss
    the negative ELBO) and the Newton-Schulz residual bound ``tau`` (fused
    route only; None on the autograd route)."""

    loss: torch.Tensor
    recon: torch.Tensor
    dynamics: torch.Tensor
    entropy: torch.Tensor
    tau: Optional[torch.Tensor] = None


def _generator(seed: Union[int, torch.Generator]) -> torch.Generator:
    if isinstance(seed, torch.Generator):
        return seed
    return torch.Generator().manual_seed(int(seed))


def init_state(
    seed: Union[int, torch.Generator],
    cfg: VJFConfig,
    device=torch.device("cuda"),
    backend: Optional[str] = None,
    batch_hint: Optional[int] = None,
) -> TrainState:
    """Build a fresh model on ``device`` from a seed or a CPU generator. The
    model goes to the card unless the caller asks for ``device="cpu"``;
    without CUDA, a call that names no device raises."""
    gen = _generator(seed)
    dtype = cfg.tdtype
    if cfg.likelihood == "gaussian":
        lik = init_gaussian_lik(cfg.init_obs_logvar, dtype=dtype, device=device)
    elif cfg.likelihood == "poisson":
        lik = init_poisson_lik()
    else:
        raise ValueError(f"unknown likelihood: {cfg.likelihood}")
    if cfg.dynamics != "rbf":
        raise NotImplementedError(_fused._SGP_TODO)
    params = Params(
        recognition=init_recognition(gen, cfg.ydim, cfg.xdim, cfg.udim,
                                     cfg.hidden_sizes, dtype=dtype, device=device),
        decoder=init_decoder(gen, cfg.xdim, cfg.ydim, dtype=dtype, device=device),
        likelihood=lik,
        prior=PriorParams(
            mean=torch.zeros(cfg.xdim, dtype=dtype, device=device),
            logvar=torch.zeros(cfg.xdim, dtype=dtype, device=device),
        ),
    )
    backend = backend or dyn.resolve_backend(cfg, batch_hint=batch_hint)
    dynamics = dyn.init_dynamics(gen, cfg, backend=backend, device=device)
    return TrainState(params=params, dynamics=dynamics,
                      lik_n_sample=torch.zeros((), dtype=dtype, device=device))


def prior(params: Params, n_batch: int) -> Gaussian:
    """The prior broadcast over the batch."""
    m, lv = params.prior.mean, params.prior.logvar
    return Gaussian(m.expand(n_batch, m.shape[-1]), lv.expand(n_batch, lv.shape[-1]))


# ---------------------------------------------------------------------------
# The autograd step
# ---------------------------------------------------------------------------


def _likelihood_loss(cfg: VJFConfig, lik_params, py: torch.Tensor,
                     y: torch.Tensor) -> torch.Tensor:
    if cfg.likelihood == "gaussian":
        return gaussian_nll(lik_params, py, y)
    return poisson_nll(py, y, clamp=cfg.poisson_clamp)


def elbo_terms(cfg: VJFConfig, params: Params, dynamics: dyn.DynamicsState, qs: Gaussian,
               y: torch.Tensor, u: Optional[torch.Tensor], eps_s: torch.Tensor,
               eps_t: torch.Tensor):
    """Forward pass and the three ELBO terms with injected sampling noise
    (``eps_s`` for x[t-1] ~ q[t-1], ``eps_t`` for x[t] ~ q[t]). Returns
    ``((l_recon, l_dyn, h), (qt, xt, xs, py, feat))``; a non-finite term
    counts as 0."""
    if cfg.dynamics != "rbf":
        raise NotImplementedError(_fused._SGP_TODO)
    xs = reparametrize(qs, eps_s)
    feat = dyn.features(dynamics, xs, u)
    pt = dyn.predict_from_features(dynamics, xs, feat, cfg.leak)
    qt = params.recognition(y, qs, u, activation=cfg.recognition_activation)
    qt = Gaussian(qt.mean, torch.clamp(qt.logvar, -cfg.logvar_clamp, cfg.logvar_clamp))
    xt = reparametrize(qt, eps_t)
    py = decode(params.decoder, xt)
    l_recon = finite_or_zero(_likelihood_loss(cfg, params.likelihood, py, y))
    l_dyn = finite_or_zero(dyn.dynamics_loss(dynamics, pt, qt, trace_quirk=cfg.trace_quirk))
    h = finite_or_zero(gaussian_entropy(qt))
    return (l_recon, l_dyn, h), (qt, xt, xs, py, feat)


def _trainable(cfg: VJFConfig, params: Params) -> Params:
    """``params`` with every gradient-trained tensor as a fresh autograd leaf
    sharing its storage (nothing here writes to it)."""
    def leaf(lin):
        return linear_from(lin.weight.detach(),
                           None if lin.bias is None else lin.bias.detach(), requires_grad=True)

    lik = params.likelihood
    if cfg.likelihood == "gaussian":
        lik = GaussianLikParams(lik.logvar.detach().requires_grad_())
    return params._replace(recognition=map_linears(params.recognition, leaf),
                           decoder=leaf(params.decoder), likelihood=lik)


def _trained_leaves(cfg: VJFConfig, params: Params):
    leaves = list(params.recognition.parameters()) + list(params.decoder.parameters())
    if cfg.likelihood == "gaussian":
        leaves.append(params.likelihood.logvar)
    return leaves


def _tree_leaves(tree):
    if isinstance(tree, tuple):
        return [x for c in tree for x in _tree_leaves(c)]
    return [tree]


def _tree_where(ok: torch.Tensor, new, old):
    if isinstance(new, tuple):
        return type(new)(*(_tree_where(ok, a, b) for a, b in zip(new, old)))
    return torch.where(ok, new, old)


def filter_step(cfg: VJFConfig, flags: StepFlags, state: TrainState, qs: Gaussian,
                y: torch.Tensor, u: Optional[torch.Tensor], eps_s: torch.Tensor,
                eps_t: torch.Tensor, lr, mask=None, channel_mask=None):
    """One filter-then-learn step with torch autograd; returns ``(state,
    qt, Metrics)``. The order is the reference's: forward, loss, clipped SGD,
    then the obs-noise running variance (from the post-SGD log-variance) and
    RLS with the state-noise running variance.

    - ``qs`` is detached; during warm-up the dynamics term is left out of
      the loss and RLS is skipped.
    - The SGD step is skipped (by select, so a NaN cannot leak into the
      parameters) unless every RAW gradient is finite; the gate is read
      before the value clip ``cfg.clip``. The decoder steps only with
      ``flags.train_decoder``.
    - The closed-form update is kept only where its inputs and every float
      leaf of its result are finite.

    The input state is never written: the step builds new modules and
    tensors. Masks raise (ROADMAP Queue 1 item 8).
    """
    _fused._no_masks(mask, channel_mask)
    qs = Gaussian(qs.mean.detach(), qs.logvar.detach())
    y = torch.atleast_2d(y)
    params = _trainable(cfg, state.params) if flags.sgd else state.params
    with torch.set_grad_enabled(flags.sgd):
        (l_recon, l_dyn, h), aux = elbo_terms(cfg, params, state.dynamics, qs, y, u,
                                              eps_s, eps_t)
        loss = l_recon - h
        if not flags.warm_up:
            loss = loss + l_dyn
        if flags.sgd:
            leaves = _trained_leaves(cfg, params)
            grads = torch.autograd.grad(loss, leaves)
    qt, xt, xs, py, feat = (Gaussian(aux[0].mean.detach(), aux[0].logvar.detach()),
                            *(a.detach() for a in aux[1:]))
    metrics = Metrics(loss.detach(), -l_recon.detach(), -l_dyn.detach(), h.detach())

    with torch.no_grad():
        new_params = state.params
        if flags.sgd:
            ok = torch.stack([torch.isfinite(g).all() for g in grads]).all()
            new = {id(p): torch.where(ok, p - lr * torch.clamp(g, -cfg.clip, cfg.clip), p)
                   for p, g in zip(leaves, grads)}

            def stepped(lin):
                return linear_from(new[id(lin.weight)],
                                   None if lin.bias is None else new[id(lin.bias)])

            new_params = Params(
                recognition=map_linears(params.recognition, stepped),
                decoder=stepped(params.decoder) if flags.train_decoder
                else state.params.decoder,
                likelihood=(GaussianLikParams(new[id(params.likelihood.logvar)])
                            if cfg.likelihood == "gaussian" else state.params.likelihood),
                prior=state.params.prior,
            )
        lik_n = state.lik_n_sample
        if flags.update and cfg.likelihood == "gaussian" and flags.update_likelihood:
            lik, lik_n = gaussian_lik_update(new_params.likelihood, lik_n, py, y,
                                             size_cap=cfg.obs_var_cap,
                                             logvar_clamp=cfg.logvar_clamp)
            new_params = new_params._replace(likelihood=lik)
        dynamics = state.dynamics
        if flags.update and flags.update_transition:
            upd = dyn.update_from_features(cfg, dynamics, xt, xs, feat, warm_up=flags.warm_up)
            checks = [xt, xs] + [v for v in _tree_leaves(upd) if v.is_floating_point()]
            upd_ok = torch.stack([torch.isfinite(v).all() for v in checks]).all()
            dynamics = _tree_where(upd_ok, upd, dynamics)
    return TrainState(new_params, dynamics, lik_n), qt, metrics


class EpochResult(NamedTuple):
    state: TrainState
    q_means: torch.Tensor    # (T, B, xdim)
    q_logvars: torch.Tensor  # (T, B, xdim)
    metrics: Metrics         # per-step tensors, each (T,)


def epoch_seed(seed: Union[int, torch.Generator]) -> int:
    """An epoch's Philox key: the int itself, or one draw from ``seed`` when
    it is a generator (a draw from a CUDA generator waits for the device)."""
    if isinstance(seed, torch.Generator):
        return int(torch.randint(0, 2**31 - 1, (), generator=seed, device=seed.device))
    return int(seed)


def run_epoch(
    cfg: VJFConfig,
    flags: StepFlags,
    state: TrainState,
    ys: torch.Tensor,
    us: torch.Tensor,
    seed: Union[int, torch.Generator],
    lr,
    noise=None,
    q0: Optional[Gaussian] = None,
    mask=None,
    channel_mask=None,
    warm_gate=None,
) -> EpochResult:
    """One pass over time (ys: (T, B, ydim), us: (T, B, udim)).

    The fused kernels run it where ``fused_enabled`` says so (float32 on the
    card, or ``fused_step='on'``); otherwise :func:`filter_step` runs once
    per step. ``seed`` (an int, or a generator to draw it from) keys the
    noise: the kernels' Philox stream, or on the autograd route one draw of
    (T, 2, B, xdim) normals from a CPU generator seeded with it.
    ``noise=(eps_s, eps_t)``, each (T, B, xdim), injects it instead.
    """
    if warm_gate is not None:
        raise NotImplementedError(_WARM_GATE_TODO)
    if ys.dtype != cfg.tdtype:
        ys = ys.to(cfg.tdtype)
    if us.dtype != cfg.tdtype:
        us = us.to(cfg.tdtype)
    if _fused.fused_enabled(cfg, state, n_batch=ys.shape[1]):
        with torch.no_grad():
            return _fused.run_epoch_fused(cfg, flags, state, ys, us, epoch_seed(seed), lr,
                                          noise=noise, q0=q0, mask=mask,
                                          channel_mask=channel_mask)
    return _run_epoch_autograd(cfg, flags, state, ys, us, seed, lr, noise, q0, mask,
                               channel_mask)


@_fused.full_f32_matmul()
def _run_epoch_autograd(cfg, flags, state, ys, us, seed, lr, noise, q0, mask, channel_mask):
    """The autograd route of :func:`run_epoch`: a Python loop over
    :func:`filter_step`, products in full f32 on the card."""
    _fused._no_masks(mask, channel_mask)
    t_len, n_batch, _ = ys.shape
    if q0 is None:
        q0 = prior(state.params, n_batch)
    if noise is None:
        gen = torch.Generator().manual_seed(epoch_seed(seed))
        eps = torch.randn((t_len, 2, n_batch, cfg.xdim), generator=gen, dtype=ys.dtype)
        eps = eps.to(ys.device)
        noise = (eps[:, 0], eps[:, 1])
    lr = _fused._lr_tensor(lr, ys.dtype, ys.device)
    q, qs, steps = q0, [], []
    for t in range(t_len):
        state, q, m = filter_step(cfg, flags, state, q, ys[t], us[t], noise[0][t],
                                  noise[1][t], lr)
        qs.append(q)
        steps.append(m[:4])
    return EpochResult(state, torch.stack([q.mean for q in qs]),
                       torch.stack([q.logvar for q in qs]),
                       Metrics(*(torch.stack(f) for f in zip(*steps))))


class EpochsResult(NamedTuple):
    state: TrainState
    q_means: torch.Tensor        # (T, B, xdim), LAST epoch only
    q_logvars: torch.Tensor      # (T, B, xdim)
    epoch_loss: torch.Tensor     # (n_epochs,) mean loss per epoch
    epoch_metrics: Metrics       # each (n_epochs,) epoch means
    max_tau: torch.Tensor        # (n_epochs,)
    hot_frac: torch.Tensor       # (n_epochs,) fraction of post-prefix steps
    #                              at or above the Newton-Schulz skip ceiling


def epoch_tau_stats(cfg: VJFConfig, metrics: Metrics, t_len: int, dtype):
    """(max finite tau, hot fraction) over the post-prefix segment.

    Skipped steps carry an inf marker in the tau stream. Deliberate deviation
    from the JAX package, which counts ``tau >= NS_TAU_MAX`` only: a NaN tau
    also counts as hot here (every non-finite tau does).
    """
    dev = metrics.loss.device
    if metrics.tau is not None and t_len > cfg.ns_prefix:
        tau_seg = metrics.tau[cfg.ns_prefix:]
        finite = torch.isfinite(tau_seg)
        max_tau = torch.max(torch.where(finite, tau_seg, torch.zeros_like(tau_seg)))
        hot = torch.mean(((tau_seg >= _fused.NS_TAU_MAX) | ~finite).to(dtype))
    else:
        max_tau = torch.zeros((), dtype=dtype, device=dev)
        hot = torch.zeros((), dtype=dtype, device=dev)
    return max_tau.to(dtype), hot


def run_epochs(
    cfg: VJFConfig,
    flags: StepFlags,
    state: TrainState,
    ys: torch.Tensor,
    us: torch.Tensor,
    seeds: Sequence[Union[int, torch.Generator]],
    lrs,
    q0: Optional[Gaussian] = None,
) -> EpochsResult:
    """``len(seeds)`` consecutive epochs over the same data, one seed (or
    generator) and one learning rate per epoch. With int seeds nothing here
    waits for the device."""
    if q0 is None:
        q0 = prior(state.params, ys.shape[1])

    def epoch(st, seed, lr):
        return run_epoch(cfg, flags, st, ys, us, seed, lr, q0=q0)

    return chain_epochs(cfg, epoch, state, ys.shape[0], seeds, lrs)


def chain_epochs(cfg: VJFConfig, epoch, state: TrainState, t_len: int, seeds,
                 lrs) -> EpochsResult:
    """``epoch(state, seed, lr) -> EpochResult`` once per seed, each from the
    previous one's state: the epoch means, the tau statistics and the last
    epoch's posteriors."""
    means, max_taus, hots = [], [], []
    res = None
    for i, seed in enumerate(seeds):
        res = epoch(state, seed, lrs[i])
        state = res.state
        means.append(Metrics(*(None if m is None else torch.mean(m) for m in res.metrics)))
        max_tau, hot = epoch_tau_stats(cfg, res.metrics, t_len, cfg.tdtype)
        max_taus.append(max_tau)
        hots.append(hot)
    mean_metrics = Metrics(*(None if f[0] is None else torch.stack(f) for f in zip(*means)))
    return EpochsResult(
        state=state,
        q_means=res.q_means,
        q_logvars=res.q_logvars,
        epoch_loss=mean_metrics.loss,
        epoch_metrics=mean_metrics,
        max_tau=torch.stack(max_taus),
        hot_frac=torch.stack(hots),
    )


# ---------------------------------------------------------------------------
# Host-side fit loop
# ---------------------------------------------------------------------------


def _isclose(a: float, b: float, rtol: float, atol: float = 1e-8) -> bool:
    """torch.isclose semantics; a non-finite value is never close (an inf
    epoch loss must not read as a plateau)."""
    if not (math.isfinite(a) and math.isfinite(b)):
        return False
    return abs(a - b) <= atol + rtol * abs(b)


@dataclass
class FitResult:
    mu: torch.Tensor         # (T, B, xdim) posterior means, final epoch
    logvar: torch.Tensor     # (T, B, xdim)
    loss: float              # final epoch mean loss
    state: TrainState
    warm_up: bool = True     # False once the plateau fired (decoder frozen)
    lr: float = float("nan")     # learning rate after the run's decay steps
    epochs_run: int = 0          # epochs executed (convergence stops early)
    # select='forecast' only: the epoch whose snapshot was returned and its
    # rollout RMSE (mu/logvar/loss/state above are that epoch's; lr stays
    # the whole run's schedule position)
    selected_epoch: Optional[int] = None
    selected_metric: float = float("nan")


def _promote_y(y, dtype: torch.dtype, device) -> torch.Tensor:
    """(T, ydim) -> (T, 1, ydim); (T, B, ydim) as it is, on ``device`` in
    ``dtype``. Data wider than ``dtype`` is narrowed before the copy to the
    device, narrower data (uint8 spike counts) is copied as it is and
    widened there."""
    y = torch.as_tensor(y)
    if y.dtype.itemsize > dtype.itemsize:
        y = y.to(dtype)
    y = y.to(device)
    if y.dtype != dtype:
        y = y.to(dtype)
    return y[:, None, :] if y.ndim == 2 else y


def _promote_u(u, t_len: int, n_batch: int, dtype: torch.dtype, device) -> torch.Tensor:
    if u is None:
        return torch.zeros((t_len, n_batch, 0), dtype=dtype, device=device)
    u = torch.as_tensor(u).to(device=device, dtype=dtype)
    if u.ndim == 2:
        u = u[:, None, :]
    if u.shape[1] != n_batch:
        u = u.expand(t_len, n_batch, u.shape[-1])
    return u


def _refuse_unported(cfg: VJFConfig, state: TrainState, mask, channel_mask, mesh,
                     checkpoint_path, resume_from) -> None:
    from . import regression

    if mesh is not None:
        raise NotImplementedError(_MESH_TODO)
    _fused._no_masks(mask, channel_mask)
    if checkpoint_path is not None or resume_from is not None:
        raise NotImplementedError(_SNAPSHOT_TODO)
    if cfg.multistep_refine > 0:
        raise NotImplementedError(_MULTISTEP_TODO)
    if cfg.dynamics != "rbf":
        raise NotImplementedError(_fused._SGP_TODO)
    if cfg.dynamics_update != "rls":
        raise NotImplementedError(dyn._KALMAN_TODO)
    if not isinstance(state.dynamics.blr, regression.NSVBLR):
        raise NotImplementedError(regression._BACKENDS_TODO)


def _bootstrap_dynamics(cfg: VJFConfig, state: TrainState, q_means: torch.Tensor,
                        us: torch.Tensor, generator: torch.Generator) -> TrainState:
    """The end of warm-up: the dynamics re-initialised from the pooled
    ``(x[t-1] -> x[t])`` pairs of the posterior means, with the controls
    ``u[t]`` that drive them."""
    xt = q_means[1:].reshape(-1, cfg.xdim)
    xs = q_means[:-1].reshape(-1, cfg.xdim)
    u_init = us[1:].reshape(-1, cfg.udim) if cfg.udim > 0 else None
    return state._replace(
        dynamics=dyn.dynamics_initialize(cfg, generator, state.dynamics, xt, xs, u_init))


def _draw_generator(gen: torch.Generator) -> torch.Generator:
    """A CPU generator seeded by one draw from ``gen`` (a JAX key split)."""
    return torch.Generator().manual_seed(epoch_seed(gen))


# The selection stream is derived from the fit's generator without drawing
# from it, so a select='forecast' fit trains bit-identically to
# select='loss' (the JAX package folds this salt into the entry key).
_SELECT_SALT = 0x5E1EC7


def _select_base(gen: torch.Generator) -> int:
    probe = torch.Generator()
    probe.set_state(gen.get_state())
    return epoch_seed(probe) ^ _SELECT_SALT


def _select_generator(base: int, epoch: int) -> torch.Generator:
    return torch.Generator().manual_seed(base * 1_000_003 + epoch)


def _demote_log(hot_frac: float, max_tau: float, epoch: int, what: str) -> None:
    logger.warning(
        "Newton-Schulz residual bound exceeded the in-kernel escalation ceiling "
        "on %.1f%% of post-prefix steps (max finite tau=%.3f, epoch %d): demoting "
        "to the autograd epoch and re-running the %s from its pre-%s state.",
        100 * hot_frac, max_tau, epoch, what, what)


def _reprobe_log(epoch: int, left: int) -> None:
    logger.info("Re-probing the mega layout at epoch %d (%d probes left): the "
                "demoted hot-tau regime may have been a transient.", epoch, left)


@_fused.full_f32_matmul()
def fit(
    cfg: VJFConfig,
    state: TrainState,
    y,
    u=None,
    *,
    seed: Union[int, torch.Generator],
    max_iter: int = 200,
    beta: Optional[float] = None,
    rtol: Optional[float] = None,
    callback=None,
    noise_hook=None,
    epochs_per_dispatch: int = 1,
    mask=None,
    channel_mask=None,
    lr0: Optional[float] = None,
    mesh=None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 0,
    resume_from: Optional[str] = None,
) -> FitResult:
    """Epoch training loop with warm-up (``VJF.fit`` of the reference).

    During warm-up the dynamics term is left out of the loss, RLS is
    skipped and the decoder trains. When the epoch loss plateaus
    (``_isclose`` against the running loss, ``rtol``; or after
    ``cfg.warmup_max`` epochs) the decoder is frozen for good and the
    dynamics are bootstrapped from the pooled posterior means of that epoch
    (``dynamics.dynamics_initialize``). After that, ``cfg.stop_patience``
    consecutive plateaus end training. The learning rate decays by
    ``cfg.lr_decay`` per epoch from ``lr0`` (default ``cfg.lr``).

    The fit runs wherever ``state`` lives; ``y`` (T, ydim) or (T, B, ydim)
    and ``u`` move there. ``seed`` (an int or a CPU generator) gives each
    epoch's seed, the bootstrap's draw and the selection stream, so the
    host waits for the device only for one read per epoch (block): the loss
    and the tau statistics.

    Hot-tau demotion: where the fused mega layout runs, an RLS epoch whose
    hot fraction exceeds ``cfg.demote_hot_frac`` is re-run from its
    pre-epoch state on the autograd route (``fused_step='off'``), whose
    exact-inverse fallback is per step; ``cfg.repromote_after`` epochs later
    the mega layout is probed again (at most ``cfg.repromote_max`` times).

    ``noise_hook(epoch) -> (eps_s, eps_t)`` injects each epoch's sampling
    noise; ``callback(epoch, loss, result)`` runs after each epoch.
    ``epochs_per_dispatch > 1`` runs :func:`_fit_blocked`. ``mesh``, the
    masks, ``checkpoint_path``/``resume_from``, ``multistep_refine``, SGP,
    the kalman learner and backends other than nsv raise
    ``NotImplementedError`` naming their ROADMAP item.
    """
    del checkpoint_every
    beta = cfg.beta if beta is None else beta
    rtol = cfg.rtol if rtol is None else rtol
    _refuse_unported(cfg, state, mask, channel_mask, mesh, checkpoint_path, resume_from)
    select_on = _validate_select(cfg)
    if epochs_per_dispatch > 1:
        if noise_hook is not None:
            raise ValueError(
                "epochs_per_dispatch > 1 is a production mode; the golden-parity "
                "noise_hook requires epochs_per_dispatch=1")
        return _fit_blocked(cfg, state, y, u, seed=seed, max_iter=max_iter, beta=beta,
                            rtol=rtol, callback=callback, k_block=int(epochs_per_dispatch),
                            lr0=lr0)
    gen = _generator(seed)
    dev = state.dynamics.blr.w_mean.device
    y = _promote_y(y, cfg.tdtype, dev)
    t_len, n_batch, _ = y.shape
    us = _promote_u(u, t_len, n_batch, cfg.tdtype, dev)
    if select_on:
        _validate_select(cfg, t_len=t_len)
        sel_base = _select_base(gen)
    best_sel = float("inf")
    best_snap = None  # (state, mu, logvar, loss, epoch) at the best metric

    # the fused route with the mega layout can demote; the states kept for a
    # re-run are never written by either route (both build new tensors)
    mega_possible = (cfg.fused_epoch == "mega"
                     and _fused.fused_enabled(cfg, state, n_batch=n_batch))
    warm_up = True
    lr = cfg.lr if lr0 is None else float(lr0)
    running_loss = float("nan")
    epoch_loss = float("nan")
    result: Optional[EpochResult] = None
    cfg_run = cfg
    mega_guard = mega_possible
    demote_epoch: Optional[int] = None
    repromotes_left = cfg.repromote_max if cfg.repromote_after > 0 else 0
    plateau_hits = 0

    for epoch in range(max_iter):
        if (demote_epoch is not None and repromotes_left > 0 and not warm_up
                and epoch - demote_epoch >= cfg.repromote_after):
            repromotes_left -= 1
            demote_epoch = None
            cfg_run = cfg
            mega_guard = True
            _reprobe_log(epoch, repromotes_left)
        seed_e = epoch_seed(gen)
        flags = StepFlags(sgd=True, update=True, warm_up=warm_up, train_decoder=warm_up)
        noise = noise_hook(epoch) if noise_hook is not None else None
        backup = state if (mega_guard and not warm_up) else None
        result = run_epoch(cfg_run, flags, state, y, us, seed_e, lr, noise=noise)
        if (mega_guard and not warm_up and result.metrics.tau is not None
                and result.metrics.tau.shape[0] > cfg.ns_prefix):
            max_tau, hot = epoch_tau_stats(cfg, result.metrics, t_len, cfg.tdtype)
            # one host read for the loss and the tau statistics
            epoch_loss, max_tau, hot_frac = torch.stack(
                [torch.mean(result.metrics.loss), max_tau, hot]).tolist()
            if hot_frac > cfg.demote_hot_frac:
                _demote_log(hot_frac, max_tau, epoch, "epoch")
                cfg_run = cfg_run.replace(fused_step="off")
                mega_guard = False
                demote_epoch = epoch
                # the autograd re-run's exact fallback factors P directly: it
                # must not start from an unrepaired indefinite backup
                backup = _fused.maybe_epoch_repair(cfg, flags, backup, n_batch)
                result = run_epoch(cfg_run, flags, backup, y, us, seed_e, lr, noise=noise)
                epoch_loss = float(torch.mean(result.metrics.loss))
            elif hot_frac > 0:
                logger.info("Rare Newton-Schulz ceiling hits (%.2f%% of steps, max finite "
                            "tau=%.3f, epoch %d): samples dropped in-kernel; staying on "
                            "the mega layout.", 100 * hot_frac, max_tau, epoch)
        else:
            epoch_loss = float(torch.mean(result.metrics.loss))
        state = result.state

        if callback is not None:
            callback(epoch, epoch_loss, result)

        converged_now = False
        if warm_up:
            plateau = _isclose(epoch_loss, running_loss, rtol)
            forced = cfg.warmup_max > 0 and epoch + 1 >= cfg.warmup_max
            if plateau or forced:
                if forced and not plateau:
                    logger.warning(
                        "Warm-up plateau never fired within warmup_max=%d epochs; forcing "
                        "the phase transition (decoder freeze + dynamics bootstrap).",
                        cfg.warmup_max)
                warm_up = False
                running_loss = epoch_loss
                logger.info("Warm up stopped at epoch %d.", epoch)
                state = _bootstrap_dynamics(cfg, state, result.q_means, us,
                                            _draw_generator(gen))
        elif _isclose(epoch_loss, running_loss, rtol):
            plateau_hits += 1
            converged_now = plateau_hits >= cfg.stop_patience
        else:
            plateau_hits = 0

        if select_on and not warm_up:
            sel = float(rollout_rmse(cfg, state, result.q_means, y, us,
                                     _select_generator(sel_base, epoch)))
            if sel < best_sel:                  # a NaN metric never selects
                best_sel = sel
                best_snap = (state, result.q_means, result.q_logvars, epoch_loss, epoch)
        if converged_now:
            logger.info("Converged at epoch %d.", epoch)
            break
        running_loss = (beta * running_loss + (1 - beta) * epoch_loss
                        if epoch > 0 else epoch_loss)
        lr *= cfg.lr_decay

    epochs_total = 0 if result is None else epoch + 1
    if select_on and best_snap is not None:
        b_state, b_mu, b_lv, b_loss, b_epoch = best_snap
        return FitResult(mu=b_mu, logvar=b_lv, loss=b_loss, state=b_state, warm_up=warm_up,
                         lr=lr, epochs_run=epochs_total, selected_epoch=b_epoch,
                         selected_metric=best_sel)
    return FitResult(mu=None if result is None else result.q_means,
                     logvar=None if result is None else result.q_logvars, loss=epoch_loss,
                     state=state, warm_up=warm_up, lr=lr, epochs_run=epochs_total)


def _fit_blocked(cfg: VJFConfig, state: TrainState, y, u=None, *,
                 seed: Union[int, torch.Generator], max_iter: int, beta: float, rtol: float,
                 callback=None, k_block: int, lr0: Optional[float] = None) -> FitResult:
    """Block-dispatch fit: ``k_block`` epochs per :func:`run_epochs` call,
    with :func:`fit`'s plateau state machine replayed on the host over the
    block's per-epoch mean losses (one host read per block).

    Deviations from the per-epoch loop, as in the JAX package: phase
    transitions (warm-up end and bootstrap, convergence, demotion) apply at
    block boundaries; a demotion re-runs the whole block from its pre-block
    state; ``callback`` gets a view whose ``metrics`` are per-epoch means up
    to that epoch and whose posteriors are the block's last epoch.

    Prefix-free continuation (``cfg.ns_prefix_free='auto'``): once a block's
    tau statistics say the carry has contracted
    (``ops.fused_step.prefix_free_next``), the next blocks dispatch with
    ``ns_prefix=0``, so no per-step exact-inverse prefix runs; the first
    post-bootstrap block always keeps the prefix. A block shorter than the
    prefix engages it structurally.
    """
    select_on = cfg.select == "forecast"
    gen = _generator(seed)
    dev = state.dynamics.blr.w_mean.device
    y = _promote_y(y, cfg.tdtype, dev)
    t_len, n_batch, _ = y.shape
    us = _promote_u(u, t_len, n_batch, cfg.tdtype, dev)
    if select_on:
        _validate_select(cfg, t_len=t_len)
        sel_base = _select_base(gen)
    best_sel = float("inf")
    best_snap = None

    mega_possible = (cfg.fused_epoch == "mega"
                     and _fused.fused_enabled(cfg, state, n_batch=n_batch))
    warm_up = True
    lr = cfg.lr if lr0 is None else float(lr0)
    running_loss = float("nan")
    epoch_loss = float("nan")
    res: Optional[EpochsResult] = None
    cfg_run = cfg
    mega_guard = mega_possible
    demote_epoch: Optional[int] = None
    repromotes_left = cfg.repromote_max if cfg.repromote_after > 0 else 0
    plateau_hits = 0
    prefix_free = False
    pf_logged = False
    epoch = 0

    while epoch < max_iter:
        if (demote_epoch is not None and repromotes_left > 0 and not warm_up
                and epoch - demote_epoch >= cfg.repromote_after):
            repromotes_left -= 1
            demote_epoch = None
            cfg_run = cfg
            mega_guard = True
            _reprobe_log(epoch, repromotes_left)
        k = min(k_block, max_iter - epoch)
        seeds = [epoch_seed(gen) for _ in range(k)]
        lrs = [lr * cfg.lr_decay ** j for j in range(k)]
        flags = StepFlags(sgd=True, update=True, warm_up=warm_up, train_decoder=warm_up)
        backup = state if (mega_guard and not warm_up) else None
        engage_pf = (prefix_free and mega_guard and not warm_up
                     and cfg.ns_prefix_free != "off" and cfg_run.ns_prefix > 0)
        cfg_disp = cfg_run.replace(ns_prefix=0) if engage_pf else cfg_run
        if engage_pf and not pf_logged:
            pf_logged = True
            logger.info("blocked fit: carry contracted (max tau < %.2f); continuing "
                        "prefix-free from the epoch-%d block.", _fused.NS_TAU_ESCALATE, epoch)
        res = run_epochs(cfg_disp, flags, state, y, us, seeds, lrs)
        # one host read per block for the control signals
        vals = torch.cat([res.epoch_loss, res.max_tau, res.hot_frac]).tolist()
        losses, max_taus, hot_fracs = vals[:k], vals[k:2 * k], vals[2 * k:]
        if mega_guard and not warm_up:
            if t_len > cfg_disp.ns_prefix:
                prefix_free = _fused.prefix_free_next(prefix_free, max(hot_fracs),
                                                      max(max_taus))
            else:
                # the whole block ran inside the protected prefix: engage
                # structurally; the engaged block's own statistics then govern
                prefix_free = True
        if mega_guard and not warm_up and max(hot_fracs) > cfg.demote_hot_frac:
            j = int(np.argmax(hot_fracs))
            _demote_log(hot_fracs[j], max_taus[j], epoch + j, "block")
            cfg_run = cfg_run.replace(fused_step="off")
            mega_guard = False
            demote_epoch = epoch + j
            backup = _fused.maybe_epoch_repair(cfg, flags, backup, n_batch)
            res = run_epochs(cfg_run, flags, backup, y, us, seeds, lrs)
            losses = res.epoch_loss.tolist()
        state = res.state

        warmup_plateau = False
        converged = False
        for j in range(k):
            epoch_loss = float(losses[j])
            if callback is not None:
                view = EpochResult(state=res.state, q_means=res.q_means,
                                   q_logvars=res.q_logvars,
                                   metrics=Metrics(*(None if a is None else a[:j + 1]
                                                     for a in res.epoch_metrics)))
                callback(epoch + j, epoch_loss, view)
            if _isclose(epoch_loss, running_loss, rtol):
                if warm_up:
                    if not warmup_plateau:
                        warmup_plateau = True
                        logger.info("Warm up stopped at epoch %d (applied at the block "
                                    "boundary).", epoch + j)
                else:
                    plateau_hits += 1
                    if plateau_hits >= cfg.stop_patience and not converged:
                        converged = True
                        logger.info("Converged at epoch %d.", epoch + j)
            elif not warm_up:
                plateau_hits = 0
            running_loss = (beta * running_loss + (1 - beta) * epoch_loss
                            if epoch + j > 0 else epoch_loss)
        epoch += k
        lr *= cfg.lr_decay ** k
        if (warm_up and not warmup_plateau and cfg.warmup_max > 0
                and epoch >= cfg.warmup_max):
            warmup_plateau = True
            logger.warning("Warm-up plateau never fired within warmup_max=%d epochs; "
                           "forcing the phase transition at the block boundary.",
                           cfg.warmup_max)
        if warm_up and warmup_plateau:
            warm_up = False
            running_loss = epoch_loss
            state = _bootstrap_dynamics(cfg, state, res.q_means, us, _draw_generator(gen))
        if select_on and not warm_up:
            sel = float(rollout_rmse(cfg, state, res.q_means, y, us,
                                     _select_generator(sel_base, epoch - 1)))
            if sel < best_sel:
                best_sel = sel
                best_snap = (state, res.q_means, res.q_logvars, epoch_loss, epoch - 1)
        if converged:
            break

    if select_on and best_snap is not None:
        b_state, b_mu, b_lv, b_loss, b_epoch = best_snap
        return FitResult(mu=b_mu, logvar=b_lv, loss=b_loss, state=b_state, warm_up=warm_up,
                         lr=lr, epochs_run=epoch, selected_epoch=b_epoch,
                         selected_metric=best_sel)
    return FitResult(mu=None if res is None else res.q_means,
                     logvar=None if res is None else res.q_logvars, loss=epoch_loss,
                     state=state, warm_up=warm_up, lr=lr, epochs_run=epoch)


# ---------------------------------------------------------------------------
# Forecasting and forecast-gated model selection
# ---------------------------------------------------------------------------


@_fused.full_f32_matmul()
def forecast(cfg: VJFConfig, state: TrainState, x0: torch.Tensor,
             seed: Union[int, torch.Generator, None], n_step: int = 1, u=None,
             noise: bool = False, draws=None):
    """Roll the latents out ``n_step`` steps from ``x0`` (B, xdim) and decode:
    ``(x, y)``, each (n_step + 1, B, ·) including the start. A fresh weight
    sample per step, drawn from ``seed`` (an int or a CPU generator) unless
    ``draws=(eps_w, eps_n)`` injects them (see ``dynamics.sampled_rollout``)."""
    if u is not None and u.shape[0] != n_step:
        raise ValueError(f"u must have length n_step={n_step} if present, got {u.shape[0]}")
    gen = None if draws is not None else _generator(seed)
    x = dyn.forecast(state.dynamics, x0, gen, n_step, u=u, noise=noise, leak=cfg.leak,
                     draws=draws)
    return x, decode(state.params.decoder, x)


def rollout_rmse(cfg: VJFConfig, state: TrainState, mu: torch.Tensor, ys: torch.Tensor,
                 us: torch.Tensor, seed: Union[int, torch.Generator]) -> torch.Tensor:
    """The ``select='forecast'`` metric, a scalar on the device: from
    ``cfg.select_starts`` evenly spaced posterior means, roll the dynamics
    ``cfg.select_horizon`` steps (all trials of every start in one batched
    rollout), decode, and take the RMSE against the observed future, on the
    count scale for Poisson."""
    t_len, n_batch, _ = ys.shape
    h = int(cfg.select_horizon)
    n_starts = min(int(cfg.select_starts), t_len - h - 1)
    starts = np.linspace(0, t_len - h - 2, n_starts).astype(int)
    dev = mu.device
    x0 = mu[torch.as_tensor(starts, device=dev)].reshape(-1, cfg.xdim)
    widx = torch.as_tensor(starts[:, None] + 1 + np.arange(h)[None, :], device=dev)
    uw = None
    if cfg.udim > 0:
        # u[t] drives the transition INTO x[t]: the rollout from start s
        # consumes u[s+1 : s+1+h]
        uw = us[widx].permute(1, 0, 2, 3).reshape(h, -1, cfg.udim)
    _, yf = forecast(cfg, state, x0, seed, n_step=h, u=uw)
    yf = yf[1:].reshape(h, len(starts), n_batch, cfg.ydim)
    if cfg.likelihood == "poisson":
        yf = torch.exp(torch.clamp(yf, max=cfg.poisson_clamp))
    err = torch.mean((yf.permute(1, 0, 2, 3) - ys[widx]) ** 2, dim=(1, 2, 3))
    return torch.sqrt(torch.mean(err))


def _validate_select(cfg: VJFConfig, t_len: Optional[int] = None) -> bool:
    """Checks ``cfg.select``; True when forecast-gated selection is on."""
    if cfg.select not in ("loss", "forecast"):
        raise ValueError(f"unknown cfg.select: {cfg.select!r}")
    if cfg.select != "forecast":
        return False
    if t_len is not None and t_len < cfg.select_horizon + 2:
        raise ValueError(f"select='forecast' needs T >= select_horizon + 2 (got T={t_len}, "
                         f"select_horizon={cfg.select_horizon})")
    return True
