"""VJF orchestrator: state, the autograd step, epochs and the fit loop
(counterpart of ``vjf_tpu/models/vjf.py``).

``run_epoch`` sends an epoch through the fused kernels
(``ops.fused_step.run_epoch_fused``) where ``fused_enabled`` says so, and
otherwise through :func:`filter_step`, the whole step as plain tensor code
with torch autograd, one Python call per timestep. Over several ranks
(``fit(mesh=...)``) the epochs are ``parallel.sharded``'s exact-sync and
relaxed-sync ones. :func:`fit` is the host-side training loop: warm-up,
the plateau that freezes the decoder and bootstraps the dynamics, RLS
epochs, hot-tau demotion to the autograd epoch, convergence,
``select='forecast'``, and in blocked mode
(:func:`_fit_blocked`) prefix-free continuation, and with SGP dynamics the
epoch-granular kernel hyperparameter step. The dynamics are the RBF system
(``models.dynamics``) or the sparse GP (``gp.sgp``), one transition
interface picked by :func:`_transition`. ``init_state`` builds the
model on the card unless the caller asks for ``device="cpu"``; the other
entry points run wherever the state lives. Where the JAX package takes a
PRNG key, the port takes an int seed or a CPU ``torch.Generator``.
"""
from __future__ import annotations

import logging
import math
import warnings
from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from ..config import StepFlags, VJFConfig
from ..gp import sgp as _sgp
from ..ops import fused_step as _fused
from ..ops.functional import (
    all_finite,
    finite_or_zero,
    gaussian_entropy,
    reparametrize,
    tree_where,
)
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
    dynamics: object              # dyn.DynamicsState | gp.sgp.SGPDynamicsState
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
    if cfg.dynamics == "sgp":
        dynamics = _sgp.init_sgp_dynamics(gen, cfg, backend=backend, device=device)
    else:
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


def _likelihood_loss(cfg: VJFConfig, lik_params, py: torch.Tensor, y: torch.Tensor,
                     weights: Optional[torch.Tensor] = None,
                     channel_mask: Optional[torch.Tensor] = None, count=None) -> torch.Tensor:
    if cfg.likelihood == "gaussian":
        return gaussian_nll(lik_params, py, y, weights=weights, channel_mask=channel_mask,
                            count=count)
    return poisson_nll(py, y, clamp=cfg.poisson_clamp, weights=weights,
                       channel_mask=channel_mask, count=count)


def _impute_y(cfg: VJFConfig, params: Params, qs: Gaussian, y: torch.Tensor,
              channel_mask: torch.Tensor) -> torch.Tensor:
    """The recognition input with missing channels imputed: a masked entry
    takes the decoder's prediction from the previous posterior mean (for
    Poisson the rate ``exp(min(eta, clamp))``, the scale of the counts).
    Detached: an input, not part of the ELBO."""
    eta = decode(params.decoder, torch.atleast_2d(qs.mean))
    if cfg.likelihood != "gaussian":
        eta = torch.exp(torch.clamp(eta, max=cfg.poisson_clamp))
    return torch.where(channel_mask > 0, y, eta.detach())


def _transition(cfg: VJFConfig):
    """The dynamics module of ``cfg.dynamics``: ``gp.sgp`` or
    ``models.dynamics``, which share one interface."""
    return _sgp if cfg.dynamics == "sgp" else dyn


def elbo_terms(cfg: VJFConfig, params: Params, dynamics, qs: Gaussian,
               y: torch.Tensor, u: Optional[torch.Tensor], eps_s: torch.Tensor,
               eps_t: torch.Tensor, weights: Optional[torch.Tensor] = None,
               channel_mask: Optional[torch.Tensor] = None):
    """Forward pass and the three ELBO terms with injected sampling noise
    (``eps_s`` for x[t-1] ~ q[t-1], ``eps_t`` for x[t] ~ q[t]). Returns
    ``((l_recon, l_dyn, h), (qt, xt, xs, py, feat))``; a non-finite term
    counts as 0. ``weights``: a (B,) 0/1 trial mask, every batch mean over
    the valid trials; ``channel_mask``: (B, ydim) 0/1, masked entries leave
    the likelihood sum and the recognition input sees :func:`_impute_y`.
    ``y`` must be finite at masked entries."""
    tr = _transition(cfg)
    xs = reparametrize(qs, eps_s)
    feat = tr.features(dynamics, xs, u)
    pt = tr.predict_from_features(dynamics, xs, feat, cfg.leak)
    y_rec = y if channel_mask is None else _impute_y(cfg, params, qs, y, channel_mask)
    qt = params.recognition(y_rec, qs, u, activation=cfg.recognition_activation)
    qt = Gaussian(qt.mean, torch.clamp(qt.logvar, -cfg.logvar_clamp, cfg.logvar_clamp))
    xt = reparametrize(qt, eps_t)
    py = decode(params.decoder, xt)
    l_recon = finite_or_zero(_likelihood_loss(cfg, params.likelihood, py, y, weights=weights,
                                              channel_mask=channel_mask))
    l_dyn = finite_or_zero(tr.dynamics_loss(dynamics, pt, qt, trace_quirk=cfg.trace_quirk,
                                            weights=weights))
    h = finite_or_zero(gaussian_entropy(qt, weights=weights))
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


def filter_step(cfg: VJFConfig, flags: StepFlags, state: TrainState, qs: Gaussian,
                y: torch.Tensor, u: Optional[torch.Tensor], eps_s: torch.Tensor,
                eps_t: torch.Tensor, lr, mask=None, channel_mask=None, warm_gate=None):
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
    - ``mask`` (B,) 0/1, ragged trials: a masked trial's ``y`` and ``u`` are
      replaced by 0 (select, so padding may be NaN), it leaves every sum
      with the means renormalised over the valid count, and its posterior
      is frozen at its last valid value; a step without a valid trial does
      not advance the recursion.
    - ``channel_mask`` (B, ydim) 0/1, missing channels: masked entries are
      replaced by 0 (before the trial mask), leave the likelihood and the
      obs-noise update, and the recognition input sees the decoder's
      prediction there (:func:`_impute_y`). Nothing freezes.
    - ``warm_gate``: a scalar tensor, the phase of an ensemble member in an
      epoch whose members are in different phases (1 = warm-up,
      ``parallel.fit_ensemble``). Given, it overrides ``flags.warm_up`` and
      ``flags.train_decoder``: the dynamics term enters the loss times ``1 -
      warm_gate``, the decoder's SGD step is selected where the gate is
      warm, and the weight update is computed and selected away there. At a
      constant 0 or 1 the result is that of the static flags (``0 * l_dyn``
      adds exact zeros, selects copy bits).

    The input state is never written: the step builds new modules and
    tensors.
    """
    qs = Gaussian(qs.mean.detach(), qs.logvar.detach())
    y = torch.atleast_2d(y)
    weights = mb = None
    zero = torch.zeros((), dtype=y.dtype, device=y.device)
    if channel_mask is not None:
        cm = torch.atleast_2d(channel_mask) > 0
        y = torch.where(cm, y, zero)
        channel_mask = cm.to(y.dtype)
    if mask is not None:
        mb = torch.atleast_1d(mask) > 0
        weights = mb.to(y.dtype)
        y = torch.where(mb[:, None], y, zero)
        if u is not None and u.shape[-1] > 0:
            u = torch.where(mb[:, None], torch.atleast_2d(u), zero)
    params = _trainable(cfg, state.params) if flags.sgd else state.params
    with torch.set_grad_enabled(flags.sgd):
        (l_recon, l_dyn, h), aux = elbo_terms(cfg, params, state.dynamics, qs, y, u,
                                              eps_s, eps_t, weights=weights,
                                              channel_mask=channel_mask)
        loss = l_recon - h
        if warm_gate is not None:
            loss = loss + (1.0 - warm_gate) * l_dyn
        elif not flags.warm_up:
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
            new_params = sgd_params(cfg, flags, state, params, grads, lr, warm_gate)
        lik_n = state.lik_n_sample
        if flags.update and cfg.likelihood == "gaussian" and flags.update_likelihood:
            lik, lik_n = gaussian_lik_update(new_params.likelihood, lik_n, py, y,
                                             size_cap=cfg.obs_var_cap,
                                             logvar_clamp=cfg.logvar_clamp, weights=weights,
                                             channel_mask=channel_mask)
            new_params = new_params._replace(likelihood=lik)
        dynamics = state.dynamics
        if flags.update and flags.update_transition:
            upd = _transition(cfg).update_from_features(cfg, dynamics, xt, xs, feat,
                                                        warm_up=flags.warm_up, weights=weights,
                                                        warm_gate=warm_gate)
            upd_ok = all_finite((xt, xs, upd))
            if weights is not None:
                upd_ok = upd_ok & (torch.sum(weights) > 0)
            dynamics = tree_where(upd_ok, upd, dynamics)
        if mb is not None:
            # the frozen carry: a masked trial's posterior stays at its last
            # valid value
            qt = Gaussian(torch.where(mb[:, None], qt.mean, qs.mean),
                          torch.where(mb[:, None], qt.logvar, qs.logvar))
    return TrainState(new_params, dynamics, lik_n), qt, metrics


def sgd_params(cfg: VJFConfig, flags: StepFlags, state: TrainState, params: Params, grads,
               lr, warm_gate=None, decoder_rows: Optional[slice] = None) -> Params:
    """:func:`filter_step`'s clipped SGD step of the trainable ``params``
    (:func:`_trainable`) by ``grads`` (of :func:`_trained_leaves`), skipped
    unless every gradient is finite; the decoder steps with
    ``flags.train_decoder`` or, with ``warm_gate``, where the gate is warm.
    ``decoder_rows``: the decoder holds these rows of the whole one, whose
    gradient ``grads`` carries."""
    ok = torch.stack([torch.isfinite(g).all() for g in grads]).all()
    dec = {id(t) for t in params.decoder.parameters()} if decoder_rows is not None else ()
    new = {id(p): torch.where(ok, p - lr * torch.clamp(g[decoder_rows] if id(p) in dec else g,
                                                       -cfg.clip, cfg.clip), p)
           for p, g in zip(_trained_leaves(cfg, params), grads)}

    def stepped(lin):
        return linear_from(new[id(lin.weight)], None if lin.bias is None else new[id(lin.bias)])

    if warm_gate is not None:
        # the decoder trains only while warm (the fit loop's freeze)
        trained, kept = stepped(params.decoder), state.params.decoder
        decoder = linear_from(torch.where(warm_gate > 0, trained.weight, kept.weight),
                              torch.where(warm_gate > 0, trained.bias, kept.bias))
    elif flags.train_decoder:
        decoder = stepped(params.decoder)
    else:
        decoder = state.params.decoder
    return Params(
        recognition=map_linears(params.recognition, stepped),
        decoder=decoder,
        likelihood=(GaussianLikParams(new[id(params.likelihood.logvar)])
                    if cfg.likelihood == "gaussian" else state.params.likelihood),
        prior=state.params.prior,
    )


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
    ``mask``: a (T,) or (T, B) 0/1 trial mask (ragged trials); a (T,) mask
    is per time and gains the trial axis. ``channel_mask``: a (T, ydim) or
    (T, B, ydim) 0/1 mask of missing observations. Both ride the kernels
    (see :func:`filter_step` for what they do). ``warm_gate``: a member's
    phase in an ensemble epoch whose members are in different phases (see
    :func:`filter_step`); a gated epoch always takes the autograd route, the
    kernels fix the phase by their flags.
    """
    if ys.dtype != cfg.tdtype:
        ys = ys.to(cfg.tdtype)
    if us.dtype != cfg.tdtype:
        us = us.to(cfg.tdtype)
    mask = _promote_mask(mask, ys.shape[0], ys.shape[1], ys.dtype, ys.device)
    channel_mask = _promote_channel_mask(channel_mask, ys.shape, ys.dtype, ys.device)
    if warm_gate is None and _fused.fused_enabled(
            cfg, state, n_batch=ys.shape[1], mask=mask is not None,
            channel_mask=channel_mask is not None):
        with torch.no_grad():
            return _fused.run_epoch_fused(cfg, flags, state, ys, us, epoch_seed(seed), lr,
                                          noise=noise, q0=q0, mask=mask,
                                          channel_mask=channel_mask)
    if warm_gate is not None:
        warm_gate = torch.as_tensor(warm_gate, dtype=ys.dtype, device=ys.device)
    return _run_epoch_autograd(cfg, flags, state, ys, us, seed, lr, noise, q0, mask,
                               channel_mask, warm_gate)


@_fused.full_f32_matmul()
def _run_epoch_autograd(cfg, flags, state, ys, us, seed, lr, noise, q0, mask, channel_mask,
                        warm_gate=None):
    """The autograd route of :func:`run_epoch`: a Python loop over
    :func:`filter_step`, products in full f32 on the card; the masks are
    promoted."""
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
                                  noise[1][t], lr,
                                  mask=None if mask is None else mask[t],
                                  channel_mask=None if channel_mask is None
                                  else channel_mask[t], warm_gate=warm_gate)
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
    mask=None,
    channel_mask=None,
    warm_gate=None,
) -> EpochsResult:
    """``len(seeds)`` consecutive epochs over the same data, one seed (or
    generator) and one learning rate per epoch, with the same masks and
    ``warm_gate`` (see :func:`run_epoch`). With int seeds nothing here waits
    for the device."""
    if q0 is None:
        q0 = prior(state.params, ys.shape[1])
    mask = _promote_mask(mask, ys.shape[0], ys.shape[1], cfg.tdtype, ys.device)
    channel_mask = _promote_channel_mask(channel_mask, ys.shape, cfg.tdtype, ys.device)

    def epoch(st, seed, lr):
        return run_epoch(cfg, flags, st, ys, us, seed, lr, q0=q0, mask=mask,
                         channel_mask=channel_mask, warm_gate=warm_gate)

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


class ChunksResult(NamedTuple):
    state: TrainState
    q_means: torch.Tensor    # (K, L, B, xdim) per-chunk posterior means
    q_logvars: torch.Tensor  # (K, L, B, xdim)
    metrics: Metrics         # per-step tensors, each (K, L)
    q_last: Gaussian         # posterior after the final chunk (the stream's carry)
    hot_frac: torch.Tensor   # scalar: hot fraction over all post-prefix steps


def run_chunks(
    cfg: VJFConfig,
    flags: StepFlags,
    state: TrainState,
    ys: torch.Tensor,
    us: torch.Tensor,
    seeds: Sequence[int],
    lr,
    q0: Optional[Gaussian] = None,
    masks=None,
    channel_masks=None,
) -> ChunksResult:
    """``K`` consecutive stream chunks, the streaming counterpart of
    :func:`run_epochs` (``VJF.filter_stream``'s ``chunks_per_dispatch``):
    the posterior carries across the chunk boundaries on the device, one
    continuous filter (where every epoch of ``run_epochs`` starts again from
    ``q0``). Only the final state is returned; the per-chunk posteriors and
    metrics are stacked. With int ``seeds`` (one per chunk) nothing here
    waits for the device. Observations may arrive in their integer wire
    dtype on the device; :func:`run_epoch` widens them there.

    :param ys: (K, L, B, ydim) stacked chunks; ``us`` (K, L, B, udim)
    :param masks: optional (K, L, B); ``channel_masks`` (K, L, B, ydim)
    """
    n_batch = ys.shape[2]
    if q0 is None:
        q0 = prior(state.params, n_batch)
    q = Gaussian(q0.mean.to(cfg.tdtype), q0.logvar.to(cfg.tdtype))
    means, logvars, steps, hots = [], [], [], []
    for i in range(ys.shape[0]):
        res = run_epoch(cfg, flags, state, ys[i], us[i], seeds[i], lr, q0=q,
                        mask=None if masks is None else masks[i],
                        channel_mask=None if channel_masks is None else channel_masks[i])
        state = res.state
        q = Gaussian(res.q_means[-1], res.q_logvars[-1])
        means.append(res.q_means)
        logvars.append(res.q_logvars)
        steps.append(res.metrics)
        hots.append(epoch_tau_stats(cfg, res.metrics, ys.shape[1], cfg.tdtype)[1])
    metrics = Metrics(*(None if f[0] is None else torch.stack(f) for f in zip(*steps)))
    return ChunksResult(state=state, q_means=torch.stack(means), q_logvars=torch.stack(logvars),
                        metrics=metrics, q_last=q, hot_frac=torch.mean(torch.stack(hots)))


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


def _copy_generator(gen: torch.Generator) -> torch.Generator:
    out = torch.Generator()
    out.set_state(gen.get_state())
    return out


class FitSnapshot(NamedTuple):
    """The whole :func:`fit` loop state at an epoch (or block) boundary, so
    that an interrupted fit resumes bit-identically to the uninterrupted
    run. Saved with ``utils.checkpoint.save_snapshot``."""

    epoch: int              # completed epochs
    warm_up: bool
    lr: float               # schedule position
    running_loss: float
    plateau_hits: int
    generator: torch.Generator   # the fit's generator (the JAX key chain)
    state: TrainState
    mu: torch.Tensor        # last epoch's (T, B, xdim) posteriors
    logvar: torch.Tensor
    epoch_loss: float
    demoted: bool           # hot-tau demotion active (cfg_run != cfg)
    demote_epoch: int       # -1 encodes None
    repromotes_left: int
    best: Optional[tuple]   # select='forecast': (state, mu, lv, loss, epoch, metric)
    cfg_digest: str         # resume-compatibility fingerprint
    # the selection stream's base: derived from the original run's
    # generator, which the resume replaces (None under select='loss')
    sel_base: Optional[int] = None
    # epochs_per_dispatch of the saving run: another blocking changes the
    # seed draws and the plateau cadence
    k_block: Optional[int] = None
    prefix_free: Optional[bool] = None   # blocked mode's continuation


def _make_fit_snapshot(cfg, epoch, warm_up, lr, running_loss, plateau_hits, gen, state,
                       result, epoch_loss, demoted, demote_epoch, repromotes_left, best_snap,
                       best_sel, sel_base=None, k_block=1, prefix_free=False) -> FitSnapshot:
    from ..utils.checkpoint import config_digest

    best = None
    if best_snap is not None:
        b_state, b_mu, b_lv, b_loss, b_epoch = best_snap
        best = (b_state, b_mu, b_lv, float(b_loss), int(b_epoch), float(best_sel))
    return FitSnapshot(
        epoch=int(epoch), warm_up=bool(warm_up), lr=float(lr),
        running_loss=float(running_loss), plateau_hits=int(plateau_hits),
        generator=_copy_generator(gen), state=state, mu=result.q_means,
        logvar=result.q_logvars, epoch_loss=float(epoch_loss), demoted=bool(demoted),
        demote_epoch=-1 if demote_epoch is None else int(demote_epoch),
        repromotes_left=int(repromotes_left), best=best, cfg_digest=config_digest(cfg),
        sel_base=sel_base, k_block=int(k_block), prefix_free=bool(prefix_free))


def _load_fit_snapshot(cfg: VJFConfig, resume_from: str, k_block: int, device) -> FitSnapshot:
    from ..utils.checkpoint import config_digest, load_snapshot

    snap = load_snapshot(resume_from, device)
    if not isinstance(snap, FitSnapshot):
        raise ValueError(f"resume_from {resume_from!r} is not a fit snapshot "
                         f"(got {type(snap).__name__})")
    if snap.cfg_digest != config_digest(cfg):
        raise ValueError("resume_from snapshot was saved under a different config; "
                         "resume with the same cfg")
    if snap.k_block is not None and snap.k_block != k_block:
        raise ValueError(f"resume_from snapshot was saved with epochs_per_dispatch="
                         f"{snap.k_block}; resuming with {k_block} would change the seed "
                         "draws and the plateau cadence (not bit-exact)")
    return snap


def _restore_fit_snapshot(snap: FitSnapshot):
    """A :class:`FitSnapshot`'s loop variables, one source for :func:`fit`
    and :func:`_fit_blocked`: ``(epoch, warm_up, lr, running_loss,
    plateau_hits, epoch_loss, demoted, demote_epoch, repromotes_left,
    best_snap, best_sel, prefix_free)``."""
    best_snap, best_sel = None, float("inf")
    if snap.best is not None:
        b_state, b_mu, b_lv, b_loss, b_epoch, b_sel = snap.best
        best_snap, best_sel = (b_state, b_mu, b_lv, b_loss, b_epoch), b_sel
    return (snap.epoch, snap.warm_up, snap.lr, snap.running_loss, snap.plateau_hits,
            snap.epoch_loss, snap.demoted, None if snap.demote_epoch < 0 else snap.demote_epoch,
            snap.repromotes_left, best_snap, best_sel, bool(snap.prefix_free))


class StreamSnapshot(NamedTuple):
    """The whole ``VJF.filter_stream`` loop state at a chunk (or K-block)
    boundary: a resumed stream continues the generator, the posterior
    carry, the learning rate, the demotion machinery and the K-block
    prefix-free contract where the saving run stopped, bit-identically. The
    caller re-positions the chunk stream at ``chunks_done``."""

    chunks_done: int        # chunks fully consumed (the stream position)
    state: TrainState
    generator: torch.Generator   # the model's generator (the JAX key chain)
    lr: float
    q_mean: Optional[torch.Tensor]     # the posterior carry; None before the
    q_logvar: Optional[torch.Tensor]   # first chunk completes
    warm_up: bool           # the stream's flag (checked on resume)
    decoder_frozen: bool
    demoted: bool           # hot-tau demotion applied (fused_step off)
    first_checked: bool     # the first chunk's synchronous check ran
    # a hot fraction read at the save and not yet acted on (-1.0 encodes
    # None): acting on it at the same point keeps the demotion's timing
    # that of the uninterrupted stream
    pending_hot: float
    k_block: int            # chunks_per_dispatch of the saving run
    cfg_digest: str


def _make_stream_snapshot(cfg, chunks_done, state, gen, lr, q, warm_up, decoder_frozen,
                          demoted, first_checked, pending_hot, k_block) -> StreamSnapshot:
    from ..utils.checkpoint import config_digest

    return StreamSnapshot(
        chunks_done=int(chunks_done), state=state, generator=_copy_generator(gen),
        lr=float(lr), q_mean=None if q is None else q.mean,
        q_logvar=None if q is None else q.logvar, warm_up=bool(warm_up),
        decoder_frozen=bool(decoder_frozen), demoted=bool(demoted),
        first_checked=bool(first_checked),
        pending_hot=-1.0 if pending_hot is None else float(pending_hot),
        k_block=int(k_block), cfg_digest=config_digest(cfg))


def _load_stream_snapshot(cfg: VJFConfig, resume_from: str, k_block: int, warm_up: bool,
                          device) -> StreamSnapshot:
    from ..utils.checkpoint import config_digest, load_snapshot

    snap = load_snapshot(resume_from, device)
    if not isinstance(snap, StreamSnapshot):
        raise ValueError(f"resume_from {resume_from!r} is not a filter_stream snapshot "
                         f"(got {type(snap).__name__})")
    # a snapshot missing its fields is refused, never trusted
    if snap.cfg_digest is None or snap.k_block is None:
        raise ValueError("resume_from snapshot is missing validation fields; refusing "
                         "to resume an unvalidatable snapshot")
    if snap.cfg_digest != config_digest(cfg):
        raise ValueError("resume_from snapshot was saved under a different config; "
                         "resume with the same cfg")
    if snap.k_block != k_block:
        raise ValueError(f"resume_from snapshot was saved with chunks_per_dispatch="
                         f"{snap.k_block}; resuming with {k_block} would change block "
                         "formation and the seed draws (not bit-exact)")
    if bool(snap.warm_up) != bool(warm_up):
        raise ValueError(f"resume_from snapshot was saved with warm_up={bool(snap.warm_up)}; "
                         f"this call passes warm_up={bool(warm_up)}")
    return snap


def wire_put(y, dtype: torch.dtype, device) -> torch.Tensor:
    """``y`` on ``device`` in its wire dtype: as it is where it is narrower
    than ``dtype`` (uint8 spike counts cross to the card at a quarter of the
    float32 bytes; the consumer widens them there), cast on the host first
    where it is wider (a float64 array would cross at twice the bytes). A
    tensor already on a device is never cast on the host."""
    y = torch.as_tensor(y)
    if y.device.type == "cpu" and y.dtype.itemsize > dtype.itemsize:
        y = y.to(dtype)
    return y.to(device)


def wire_ingest(y, dtype: torch.dtype, device) -> torch.Tensor:
    """:func:`wire_put`, then the cast to ``dtype`` on the device: the one
    place that keeps the integer wire format's contract."""
    y = wire_put(y, dtype, device)
    return y if y.dtype == dtype else y.to(dtype)


def _promote_y(y, dtype: torch.dtype, device) -> torch.Tensor:
    """(T, ydim) -> (T, 1, ydim); (T, B, ydim) as it is; on ``device`` in
    ``dtype`` through :func:`wire_ingest`."""
    y = wire_ingest(y, dtype, device)
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


def _promote_mask(mask, t_len: int, n_batch: int, dtype: torch.dtype,
                  device) -> Optional[torch.Tensor]:
    """A (T,) or (T, B) trial mask as (T, B) in ``dtype`` on ``device``. A
    (T,) mask is per time: it gains the trial axis, never read as a
    per-trial mask (which broadcasting would do at T == B)."""
    if mask is None:
        return None
    mask = torch.as_tensor(mask).to(device=device, dtype=dtype)
    if mask.ndim == 1:
        mask = mask[:, None]
    return mask.expand(t_len, n_batch)


def _promote_channel_mask(channel_mask, y_shape, dtype: torch.dtype,
                          device) -> Optional[torch.Tensor]:
    """A (T, ydim) or (T, B, ydim) channel mask as (T, B, ydim)."""
    if channel_mask is None:
        return None
    cm = torch.as_tensor(channel_mask).to(device=device, dtype=dtype)
    if cm.ndim == 2:
        cm = cm[:, None, :]
    return cm.expand(*y_shape)


def _validate_multistep(cfg: VJFConfig, mask) -> None:
    """``cfg.multistep_refine``: refused for controls and masks, up front
    (the rollout has no control or validity alignment), and deprecated, as
    in the JAX package."""
    if cfg.multistep_refine <= 0:
        return
    if cfg.udim > 0 or mask is not None:
        raise ValueError("multistep_refine supports autonomous, unmasked fits only "
                         "(the rollout has no control/validity alignment)")
    warnings.warn(
        "cfg.multistep_refine is deprecated: the measured A/B shows it does not improve "
        "(VdP: worsens) long-horizon forecasts; use cfg.select='forecast' instead "
        "(docs/RESULTS.md 'Forecast-skill training'). The knob will be removed in a "
        "future release.", DeprecationWarning, stacklevel=3)


def _bootstrap_dynamics(cfg: VJFConfig, state: TrainState, q_means: torch.Tensor,
                        us: torch.Tensor, generator: torch.Generator,
                        pair_w: Optional[torch.Tensor] = None) -> TrainState:
    """The end of warm-up: the dynamics re-initialised from the pooled
    ``(x[t-1] -> x[t])`` pairs of the posterior means, with the controls
    ``u[t]`` that drive them. ``pair_w``: the (N,) validity of each pair
    (ragged trials: both ends observed; a frozen carry's pair has ``dx = 0``
    and would teach ``f = 0``)."""
    xt = q_means[1:].reshape(-1, cfg.xdim)
    xs = q_means[:-1].reshape(-1, cfg.xdim)
    return state._replace(dynamics=_transition(cfg).dynamics_initialize(
        cfg, generator, state.dynamics, xt, xs, _pooled_controls(cfg, us, pair_w),
        weights=pair_w))


def _pooled_controls(cfg: VJFConfig, us: torch.Tensor,
                     pair_w: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """The pooled controls of the pairs, an invalid pair's row set to 0:
    padded ``u`` (NaN under ragged masks) leaves the RLS statistics through
    ``pair_w`` but would still reach ``max ||cat(xs, u)||`` of the re-init,
    and ``0 * NaN`` is NaN. The posterior means need no such guard (the
    frozen carry keeps them finite)."""
    if cfg.udim == 0:
        return None
    u = us[1:].reshape(-1, cfg.udim)
    if pair_w is not None:
        u = torch.where(pair_w[:, None] > 0, u, torch.zeros_like(u))
    return u


def _pair_weights(mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """The validity of the pooled ``(x[t-1] -> x[t])`` pairs of a (T, B)
    trial mask: both ends observed."""
    return None if mask is None else (mask[1:] * mask[:-1]).reshape(-1)


def _demote_masked_small_sgp(cfg: VJFConfig, mask: Optional[torch.Tensor]) -> VJFConfig:
    """The kernels' small-batch SGP gate (:func:`ops.fused_step.fused_enabled`)
    sizes itself on the padded batch; under a trial mask the effective
    count of a step is what keeps the trace bound hot. The mask is known
    when the fit starts, so a fit any step of which has fewer valid trials
    than ``sgp_fused_min_batch`` takes the autograd epoch throughout (one
    log line). Explicit ``fused_step='on'``/``'off'`` is kept."""
    if mask is None or cfg.dynamics != "sgp" or cfg.fused_step != "auto":
        return cfg
    eff = int(torch.min(torch.sum(mask > 0, dim=1)))
    if eff < cfg.sgp_fused_min_batch:
        logger.info("ragged SGP fit: min per-step valid count %d < sgp_fused_min_batch %d; "
                    "routing to the autograd epoch (per-step exact-inverse fallback).",
                    eff, cfg.sgp_fused_min_batch)
        return cfg.replace(fused_step="off")
    return cfg


def _sgp_adapt_step(cfg: VJFConfig, state: TrainState, q_means: torch.Tensor,
                    us: torch.Tensor, pair_w: Optional[torch.Tensor] = None) -> TrainState:
    """The slow-timescale SGP hyperparameter step on the pooled posterior
    means (``gp.sgp.adapt_hyperparams``), shared by both fit loops;
    ``pair_w`` as in :func:`_bootstrap_dynamics`."""
    return state._replace(dynamics=_sgp.adapt_hyperparams(
        cfg, state.dynamics, q_means[1:].reshape(-1, cfg.xdim),
        q_means[:-1].reshape(-1, cfg.xdim), _pooled_controls(cfg, us, pair_w),
        weights=pair_w))


@_fused.full_f32_matmul()
def multistep_refine(cfg: VJFConfig, state: TrainState, mu: torch.Tensor,
                     horizon: Optional[int] = None, weight: Optional[float] = None,
                     n_iter: Optional[int] = None) -> TrainState:
    """K-step rollout-consistency refinement of the velocity field
    (``cfg.multistep_refine``, deprecated; no reference counterpart).

    With leak ``l`` and ``lam = 1 - l`` the rollout telescopes to
    ``x_{i+K} = lam^K x_i + sum_j lam^(K-1-j) phi(x_j) w``, so along the
    current rolled path the K-step displacement is linear in ``w`` with the
    path-accumulated features. Their ridge solution over every start in the
    epoch's posterior means ``mu`` (T, B, xdim) is found through the
    relative-floored eigh and blended in, ``w <- (1 - a) w + a w_ms``; each
    iteration re-linearises around the improved path. P and V are left as
    they are. Controls are not supported (``fit`` refuses them)."""
    from ..ops.linalg import eigh_floor_inv_pair

    horizon = cfg.multistep_refine if horizon is None else horizon
    weight = cfg.multistep_weight if weight is None else weight
    n_iter = cfg.multistep_iters if n_iter is None else n_iter
    if horizon <= 1 or mu.shape[0] <= horizon:
        return state
    tr = _transition(cfg)
    d = state.dynamics
    lam = 1.0 - cfg.leak
    k, xd = int(horizon), cfg.xdim
    x0 = mu[:-k].reshape(-1, xd)
    tgt = (mu[k:] - (lam ** k) * mu[:-k]).reshape(-1, xd)
    v = k * torch.exp(d.logvar)
    for _ in range(n_iter):
        xj, acc = x0, None
        for j in range(k):
            feat = tr.features(d, xj)
            c = lam ** (k - 1 - j)
            acc = c * feat if acc is None else acc + c * feat
            xj = lam * xj + feat @ d.blr.w_mean
        # the ridge solve in at least f32: the pooled Gram reaches cond 1e8
        sol = torch.promote_types(acc.dtype, torch.float32)
        a, vs = acc.to(sol), v.to(sol)
        p = torch.eye(a.shape[1], dtype=sol, device=a.device) + (a.T @ a) / vs
        _, v_sol = eigh_floor_inv_pair(p)
        w_ms = (v_sol @ ((a.T @ tgt.to(sol)) / vs)).to(d.blr.w_mean.dtype)
        d = d._replace(blr=d.blr._replace(w_mean=(1.0 - weight) * d.blr.w_mean + weight * w_ms))
    return state._replace(dynamics=d)


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


class _Solo:
    """The single-card counterpart of ``parallel.sharded.FitGroup``, what the
    fit loops do over a ``dp`` group: here every method leaves its argument
    as it is."""

    def state(self, cfg: VJFConfig, state: TrainState) -> TrainState:
        return state

    def whole(self, res):
        return res

    def agree(self, vals) -> list:
        return list(vals)

    def save(self, save_fn, path: str, snapshot) -> None:
        save_fn(path, snapshot)


_SOLO = _Solo()


def _fit_group(mesh, state: TrainState):
    """``parallel.sharded.FitGroup`` over ``mesh`` on the state's device; a
    ``mesh`` that is neither a process group nor a ``parallel.Mesh`` raises
    ``ValueError``."""
    from ..parallel.sharded import FitGroup

    return FitGroup(mesh, state.dynamics.blr.w_mean.device)


def _epoch_runner(cfg: VJFConfig, mesh, y: torch.Tensor, us: torch.Tensor, masks: dict):
    """``(run(cfg_run, flags, state, seed, lr, noise) -> EpochResult, local
    batch)`` of the per-epoch :func:`fit`: :func:`run_epoch` on one card;
    over ``mesh`` the exact-sync sharded epoch on the whole batch (its
    route decided on it), or with ``cfg.sync_every != 1`` the relaxed-sync
    one on this rank's trials, which refuses masks and warns where the JAX
    package warns. The local batch is the trials one rank carries, the
    batch over the ``dp`` axis (a deliberate deviation: the JAX package
    divides by every device of the mesh, ``tp`` too)."""
    if mesh is None:
        def run(c, flags, st, seed, lr, noise):
            return run_epoch(c, flags, st, y, us, seed, lr, noise=noise, **masks)

        return run, y.shape[1]
    from ..parallel import sharded

    if cfg.sync_every == 1:
        def run(c, flags, st, seed, lr, noise):
            return sharded.make_sharded_epoch(c, flags, mesh)(st, y, us, seed, lr, **masks)

        return run, y.shape[1] // sharded._rank_and_size(mesh)[1]
    y_l, us_l = sharded.shard_trials(y, us, mesh)
    b_local = y_l.shape[1]
    if masks["mask"] is not None or masks["channel_mask"] is not None:
        raise ValueError("sync_every != 1 does not support masks; use the exact per-step-sync "
                         "path (cfg.sync_every=1) for ragged trials")
    if cfg.rls_shrink >= 1.0:
        logger.warning(
            "sync_every=%d with rls_shrink=1.0: the per-chip RLS between merges is a pure "
            "accumulation over B_local=%d trials -- measured to destabilize the merged "
            "dynamics. Set cfg.rls_shrink<1 (e.g. 0.999) + chol_jitter (e.g. 1e-3); "
            "cfg.sync_trust damping is active but only bounds the per-merge step, not the "
            "accumulation.", cfg.sync_every, b_local)
    if cfg.select != "forecast":
        logger.warning(
            "sync_every=%d without select='forecast': relaxed-sync merges can destroy "
            "forecast skill while latent reconstruction looks healthy (measured: VdP K=8 "
            "rollout RMSE 12.2 vs 0.91 persistence). Set cfg.select='forecast' to snapshot "
            "the best post-merge state, or gate your own quality checks on forecast skill, "
            "never latent R^2.", cfg.sync_every)

    def run(c, flags, st, seed, lr, noise):
        return sharded.run_epoch_sync_every(c, flags, st, y_l, us_l, seed, lr, mesh,
                                            cfg.sync_every)

    return run, b_local


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
    ``epochs_per_dispatch > 1`` runs :func:`_fit_blocked`. With SGP
    dynamics and ``cfg.sgp_adapt_lr > 0`` each RLS epoch that does not end
    the fit is followed by one hyperparameter step
    (``gp.sgp.adapt_hyperparams``) on its posterior means.

    ``mask`` (T,) or (T, B), 0/1: ragged trials (:func:`pad_trials` builds
    it); ``channel_mask`` (T, ydim) or (T, B, ydim), 0/1: missing channels.
    Both ride every epoch (:func:`filter_step`), and the padded entries of
    ``y`` and ``u`` may hold NaN. The bootstrap and the SGP adaptation pool
    only the pairs whose two ends are observed; a ragged SGP fit with fewer
    than ``sgp_fused_min_batch`` valid trials at some step takes the
    autograd epoch (:func:`_demote_masked_small_sgp`); ``select='forecast'``
    refuses masks. ``cfg.multistep_refine > 0`` (deprecated, with a warning)
    blends :func:`multistep_refine` into the weights after each RLS epoch
    (block) that does not end the fit; it refuses controls and masks.

    ``checkpoint_path`` with ``checkpoint_every=K``: save the whole loop
    state (:class:`FitSnapshot`: the state, the phase, the plateau machine,
    the learning rate, the generator, the demotion and selection machinery)
    every K epochs (at block boundaries in blocked mode), atomically, to
    that one file. ``resume_from``: the path of such a snapshot; the fit
    resumes bit-identically to the uninterrupted run (same cfg, data and
    ``epochs_per_dispatch``; the snapshot supersedes ``state``, ``seed``
    and ``lr0``), on the device of ``state``. Not with ``noise_hook``.

    The kernels carry the nsv RLS learner only: a state of the precision or
    covariance backend, or ``dynamics_update='kalman'``, trains every epoch
    on the autograd route, and no demotion, repair or prefix logic runs
    (as in the JAX package, whose fused gate asks for the nsv backend).

    ``mesh``: a ``dp`` process group (``parallel.make_dp_group``) or a
    ``dp`` x ``tp`` mesh (``parallel.make_mesh``) to train over several
    cards, one rank a process. Every rank calls ``fit`` with the whole
    ``y``, the whole masks and the same seed; each runs its part from rank
    0's state (``parallel.shard_state``) under the same host loop. With
    ``cfg.sync_every == 1`` every epoch (block) is the exact-sync sharded
    epoch (``parallel.make_sharded_epoch``, masks ride along, no hot-tau
    demotion), which trains every configuration: where the kernels take it
    the fused route (its trials a rank over ``dp``, one all-reduce a step),
    else the autograd route (its trials over ``dp`` and its channels over
    ``tp``, two all-reduces a step). With ``cfg.sync_every != 1``
    (per-epoch mode only; the blocked mode always syncs exactly, as in the
    JAX package) every epoch is ``parallel.run_epoch_sync_every`` over the
    ``dp`` axis: masks raise, the demotion watch is judged on the rank's
    batch and a demoted epoch re-runs the relaxed path on the autograd
    route. The bootstrap, the SGP step, ``multistep_refine``, selection and
    the result read the whole batch's posteriors (gathered), and rank 0's
    state is broadcast after each such step; rank 0 writes the snapshots.
    The state and ``FitResult`` returned are whole on every rank.
    ``callback`` gets this rank's posteriors. Not with ``noise_hook``.
    """
    beta = cfg.beta if beta is None else beta
    rtol = cfg.rtol if rtol is None else rtol
    group = _SOLO if mesh is None else _fit_group(mesh, state)
    if mesh is not None and noise_hook is not None:
        raise ValueError("mesh and noise_hook are mutually exclusive")
    _validate_multistep(cfg, mask)
    select_on = _validate_select(cfg, mask, channel_mask)
    if resume_from is not None and noise_hook is not None:
        raise ValueError("resume_from and noise_hook are mutually exclusive")
    if epochs_per_dispatch > 1:
        if noise_hook is not None:
            raise ValueError(
                "epochs_per_dispatch > 1 is a production mode; the golden-parity "
                "noise_hook requires epochs_per_dispatch=1")
        return _fit_blocked(cfg, state, y, u, seed=seed, max_iter=max_iter, beta=beta,
                            rtol=rtol, callback=callback, k_block=int(epochs_per_dispatch),
                            lr0=lr0, mask=mask, channel_mask=channel_mask, mesh=mesh,
                            checkpoint_path=checkpoint_path,
                            checkpoint_every=checkpoint_every, resume_from=resume_from)
    gen = _generator(seed)
    dev = state.dynamics.blr.w_mean.device
    y = _promote_y(y, cfg.tdtype, dev)
    t_len, n_batch, _ = y.shape
    us = _promote_u(u, t_len, n_batch, cfg.tdtype, dev)
    mask = _promote_mask(mask, t_len, n_batch, cfg.tdtype, dev)
    channel_mask = _promote_channel_mask(channel_mask, y.shape, cfg.tdtype, dev)
    masks = dict(mask=mask, channel_mask=channel_mask)
    pair_w = _pair_weights(mask)
    cfg = _demote_masked_small_sgp(cfg, mask)
    # loaded after the cfg rewrite above: the snapshot digests the resolved cfg
    snap = None if resume_from is None else _load_fit_snapshot(cfg, resume_from, 1, dev)
    if snap is not None:
        state, gen = snap.state, snap.generator
    state = group.state(cfg, state)
    if select_on:
        _validate_select(cfg, t_len=t_len)
        sel_base = _select_base(gen)
    best_sel = float("inf")
    best_snap = None  # (state, mu, logvar, loss, epoch) at the best metric
    epoch_fn, local_batch = _epoch_runner(cfg, mesh, y, us, masks)

    # the fused route with the mega layout can demote (not the exact-sync
    # sharded epoch); the states kept for a re-run are never written by
    # either route (both build new tensors)
    mega_possible = ((mesh is None or cfg.sync_every != 1) and cfg.fused_epoch == "mega"
                     and _fused.fused_enabled(cfg, state, n_batch=local_batch,
                                              mask=mask is not None,
                                              channel_mask=channel_mask is not None))
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
    start_epoch = 0
    if snap is not None:
        (start_epoch, warm_up, lr, running_loss, plateau_hits, epoch_loss, demoted,
         demote_epoch, repromotes_left, r_best, r_sel, _) = _restore_fit_snapshot(snap)
        if demoted:
            cfg_run = cfg.replace(fused_step="off")
            mega_guard = False
        if r_best is not None:
            best_snap, best_sel = r_best, r_sel
        if select_on and snap.sel_base is not None:
            sel_base = snap.sel_base

    for epoch in range(start_epoch, max_iter):
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
        result = epoch_fn(cfg_run, flags, state, seed_e, lr, noise)
        if (mega_guard and not warm_up and result.metrics.tau is not None
                and result.metrics.tau.shape[0] > cfg.ns_prefix):
            max_tau, hot = epoch_tau_stats(cfg, result.metrics, t_len, cfg.tdtype)
            # one host read for the loss and the tau statistics
            epoch_loss, max_tau, hot_frac = group.agree(torch.stack(
                [torch.mean(result.metrics.loss), max_tau, hot]).tolist())
            if hot_frac > cfg.demote_hot_frac:
                _demote_log(hot_frac, max_tau, epoch, "epoch")
                cfg_run = cfg_run.replace(fused_step="off")
                mega_guard = False
                demote_epoch = epoch
                # the autograd re-run's exact fallback factors P directly: it
                # must not start from an unrepaired indefinite backup
                backup = _fused.maybe_epoch_repair(cfg, flags, backup, local_batch)
                result = epoch_fn(cfg_run, flags, backup, seed_e, lr, noise)
                epoch_loss = group.agree([float(torch.mean(result.metrics.loss))])[0]
            elif hot_frac > 0:
                logger.info("Rare Newton-Schulz ceiling hits (%.2f%% of steps, max finite "
                            "tau=%.3f, epoch %d): samples dropped in-kernel; staying on "
                            "the mega layout.", 100 * hot_frac, max_tau, epoch)
        else:
            epoch_loss = group.agree([float(torch.mean(result.metrics.loss))])[0]
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
                state = group.state(cfg, _bootstrap_dynamics(
                    cfg, state, group.whole(result).q_means, us, _draw_generator(gen), pair_w))
        else:
            if _isclose(epoch_loss, running_loss, rtol):
                plateau_hits += 1
                converged_now = plateau_hits >= cfg.stop_patience
            else:
                plateau_hits = 0
            if not converged_now and cfg.dynamics == "sgp" and cfg.sgp_adapt_lr > 0:
                state = group.state(cfg, _sgp_adapt_step(cfg, state, group.whole(result).q_means,
                                                         us, pair_w))
            if not converged_now and cfg.multistep_refine > 0:
                state = group.state(cfg, multistep_refine(cfg, state,
                                                          group.whole(result).q_means))

        if select_on and not warm_up:
            whole = group.whole(result)
            sel = group.agree([float(rollout_rmse(cfg, state, whole.q_means, y, us,
                                                  _select_generator(sel_base, epoch)))])[0]
            if sel < best_sel:                  # a NaN metric never selects
                best_sel = sel
                best_snap = (state, whole.q_means, whole.q_logvars, epoch_loss, epoch)
        if converged_now:
            logger.info("Converged at epoch %d.", epoch)
            break
        running_loss = (beta * running_loss + (1 - beta) * epoch_loss
                        if epoch > 0 else epoch_loss)
        lr *= cfg.lr_decay
        if (checkpoint_path is not None and checkpoint_every > 0
                and (epoch + 1) % checkpoint_every == 0):
            from ..utils.checkpoint import save_snapshot

            group.save(save_snapshot, checkpoint_path, _make_fit_snapshot(
                cfg, epoch + 1, warm_up, lr, running_loss, plateau_hits, gen, state,
                group.whole(result), epoch_loss, cfg_run != cfg, demote_epoch,
                repromotes_left, best_snap if select_on else None, best_sel,
                sel_base=sel_base if select_on else None))

    epochs_total = start_epoch if result is None else epoch + 1
    return _fit_result(select_on, best_snap, best_sel, result, snap, epoch_loss, state,
                       warm_up, lr, epochs_total, cfg, group)


def _fit_result(select_on, best_snap, best_sel, result, snap, epoch_loss, state, warm_up, lr,
                epochs_run, cfg, group) -> FitResult:
    """The :class:`FitResult` both fit loops return: the selected epoch's
    under ``select='forecast'`` (its state rank 0's over a group); the
    snapshot's posteriors when a resume landed at or past ``max_iter`` and
    ran nothing; the whole batch's posteriors over a group."""
    if select_on and best_snap is not None:
        b_state, b_mu, b_lv, b_loss, b_epoch = best_snap
        return FitResult(mu=b_mu, logvar=b_lv, loss=b_loss, state=group.state(cfg, b_state),
                         warm_up=warm_up, lr=lr, epochs_run=epochs_run, selected_epoch=b_epoch,
                         selected_metric=best_sel)
    if result is not None:
        result = group.whole(result)
        mu, logvar = result.q_means, result.q_logvars
    elif snap is not None:
        mu, logvar = snap.mu, snap.logvar
    else:
        mu = logvar = None
    return FitResult(mu=mu, logvar=logvar, loss=epoch_loss, state=state, warm_up=warm_up,
                     lr=lr, epochs_run=epochs_run)


def _fit_blocked(cfg: VJFConfig, state: TrainState, y, u=None, *,
                 seed: Union[int, torch.Generator], max_iter: int, beta: float, rtol: float,
                 callback=None, k_block: int, lr0: Optional[float] = None, mask=None,
                 channel_mask=None, mesh=None, checkpoint_path: Optional[str] = None,
                 checkpoint_every: int = 0, resume_from: Optional[str] = None) -> FitResult:
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
    prefix engages it structurally. The masks ride every block whole, as in
    :func:`fit`. A snapshot is saved at the first block boundary at or past
    each multiple of ``checkpoint_every`` epochs.

    ``mesh``: every block is K exact-sync sharded epochs
    (``parallel.make_sharded_epochs``, either route) whatever
    ``cfg.sync_every`` says, as in the JAX package; the sharded epoch keeps
    the per-step exact-inverse fallback and has no mega layout, so neither
    the demotion nor prefix-free continuation applies. The rest as in
    :func:`fit` over a mesh.
    """
    select_on = cfg.select == "forecast"
    group = _SOLO if mesh is None else _fit_group(mesh, state)
    gen = _generator(seed)
    dev = state.dynamics.blr.w_mean.device
    y = _promote_y(y, cfg.tdtype, dev)
    t_len, n_batch, _ = y.shape
    us = _promote_u(u, t_len, n_batch, cfg.tdtype, dev)
    mask = _promote_mask(mask, t_len, n_batch, cfg.tdtype, dev)
    channel_mask = _promote_channel_mask(channel_mask, y.shape, cfg.tdtype, dev)
    masks = dict(mask=mask, channel_mask=channel_mask)
    pair_w = _pair_weights(mask)
    cfg = _demote_masked_small_sgp(cfg, mask)
    snap = None if resume_from is None else _load_fit_snapshot(cfg, resume_from, k_block, dev)
    if snap is not None:
        state, gen = snap.state, snap.generator
    state = group.state(cfg, state)
    if select_on:
        _validate_select(cfg, t_len=t_len)
        sel_base = _select_base(gen)
    best_sel = float("inf")
    best_snap = None

    if mesh is None:
        def epochs_fn(c, flags, st, seeds, lrs):
            return run_epochs(c, flags, st, y, us, seeds, lrs, **masks)
    else:
        from ..parallel import sharded

        def epochs_fn(c, flags, st, seeds, lrs):
            return sharded.make_sharded_epochs(c, flags, mesh)(st, y, us, seeds, lrs, **masks)
    mega_possible = (mesh is None and cfg.fused_epoch == "mega"
                     and _fused.fused_enabled(cfg, state, n_batch=n_batch,
                                              mask=mask is not None,
                                              channel_mask=channel_mask is not None))
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
    if snap is not None:
        (epoch, warm_up, lr, running_loss, plateau_hits, epoch_loss, demoted, demote_epoch,
         repromotes_left, r_best, r_sel, prefix_free) = _restore_fit_snapshot(snap)
        if demoted:
            cfg_run = cfg.replace(fused_step="off")
            mega_guard = False
        if r_best is not None:
            best_snap, best_sel = r_best, r_sel
        if select_on and snap.sel_base is not None:
            sel_base = snap.sel_base

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
        res = epochs_fn(cfg_disp, flags, state, seeds, lrs)
        # one host read per block for the control signals
        vals = group.agree(torch.cat([res.epoch_loss, res.max_tau, res.hot_frac]).tolist())
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
            res = epochs_fn(cfg_run, flags, backup, seeds, lrs)
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
            state = group.state(cfg, _bootstrap_dynamics(cfg, state, group.whole(res).q_means,
                                                         us, _draw_generator(gen), pair_w))
        elif not warm_up and not converged:
            if cfg.dynamics == "sgp" and cfg.sgp_adapt_lr > 0:
                state = group.state(cfg, _sgp_adapt_step(cfg, state, group.whole(res).q_means,
                                                         us, pair_w))
            if cfg.multistep_refine > 0:
                # block-granular, like every phase action here
                state = group.state(cfg, multistep_refine(cfg, state,
                                                          group.whole(res).q_means))
        if select_on and not warm_up:
            whole = group.whole(res)
            sel = group.agree([float(rollout_rmse(cfg, state, whole.q_means, y, us,
                                                  _select_generator(sel_base, epoch - 1)))])[0]
            if sel < best_sel:
                best_sel = sel
                best_snap = (state, whole.q_means, whole.q_logvars, epoch_loss, epoch - 1)
        if converged:
            break
        if (checkpoint_path is not None and checkpoint_every > 0
                and epoch // checkpoint_every > (epoch - k) // checkpoint_every):
            from ..utils.checkpoint import save_snapshot

            group.save(save_snapshot, checkpoint_path, _make_fit_snapshot(
                cfg, epoch, warm_up, lr, running_loss, plateau_hits, gen, state,
                group.whole(res), epoch_loss, cfg_run != cfg, demote_epoch, repromotes_left,
                best_snap if select_on else None, best_sel,
                sel_base=sel_base if select_on else None, k_block=k_block,
                prefix_free=prefix_free))

    return _fit_result(select_on, best_snap, best_sel, res, snap, epoch_loss, state, warm_up,
                       lr, epoch, cfg, group)


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
    x = _transition(cfg).forecast(state.dynamics, x0, gen, n_step, u=u, noise=noise,
                                  leak=cfg.leak, draws=draws)
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


def _validate_select(cfg: VJFConfig, mask=None, channel_mask=None,
                     t_len: Optional[int] = None) -> bool:
    """Checks ``cfg.select``; True when forecast-gated selection is on. The
    rollout windows have no validity alignment: a masked fit raises."""
    if cfg.select not in ("loss", "forecast"):
        raise ValueError(f"unknown cfg.select: {cfg.select!r}")
    if cfg.select != "forecast":
        return False
    if mask is not None or channel_mask is not None:
        raise ValueError("select='forecast' supports unmasked fits only (rollout windows "
                         "have no validity alignment); use select='loss' for ragged or "
                         "dropout data")
    if t_len is not None and t_len < cfg.select_horizon + 2:
        raise ValueError(f"select='forecast' needs T >= select_horizon + 2 (got T={t_len}, "
                         f"select_horizon={cfg.select_horizon})")
    return True
