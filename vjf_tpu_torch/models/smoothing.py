"""Post-hoc parallel smoothing of a trained VJF model (counterpart of
``vjf_tpu/models/smoothing.py``).

The online filter is causal; once a model is learned, the latents can be
re-inferred offline with future information. The learned system is locally
linear-Gaussian: linearize the RBF (or SGP) velocity field at a reference
point and run the O(log T)-depth associative-scan RTS smoother
(:mod:`vjf_tpu_torch.ops.pkalman`). The Poisson likelihood takes the
iterated-Laplace variant.

Every smoother here runs natively batched: :func:`smooth_batch` smooths
(T, B, ydim) trials in one call of the batched scan, where the JAX package
``vmap``s the single-sequence smoother over trials; over a ``dp`` process
group or a mesh (``mesh=``) each ``dp`` rank smooths its slice of the
trials (its ``tp`` peers the same slice) and the results are gathered.
The whole smoother runs with TF32 off.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..config import VJFConfig
from ..ops import pkalman
from ..ops.fused_step import full_f32_matmul
from .vjf import TrainState, _transition, wire_ingest

def _device(state: TrainState) -> torch.device:
    return state.params.prior.mean.device


def _as(cfg: VJFConfig, state: TrainState, v) -> torch.Tensor:
    return torch.as_tensor(v).to(dtype=cfg.tdtype, device=_device(state))


def _lead(v: torch.Tensor, lead: Tuple[int, ...]) -> torch.Tensor:
    """``v`` (d,), (T, d) or (*lead, d) as (*lead, d): a point is shared by
    every entry, a (T, d) sequence by every trial."""
    if v.ndim == 1:
        return v.expand(lead + v.shape)
    if v.shape[:-1] != lead:
        v = v.reshape((v.shape[0],) + (1,) * (len(lead) - 1) + v.shape[-1:])
    return v.expand(lead + v.shape[-1:])


def linearize_dynamics(
    cfg: VJFConfig,
    state: TrainState,
    x_ref=None,
    u_ref=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """First-order model ``x[t] ~= A x[t-1] + c`` of the learned transition
    mean around ``(x_ref, u_ref)``.

    ``x_ref`` is one ``(xdim,)`` point (default: the origin) or a batch of
    points ``(..., xdim)``, which gives per-point ``(..., xdim, xdim)`` and
    ``(..., xdim)`` affine models (no time shift here; see
    :func:`_linearize_for_sequence`). ``u_ref``: the controls the transition
    is evaluated at, required when ``cfg.udim > 0``: one ``(udim,)`` point
    or per point. Controls are known, so they enter the offset ``c``
    exactly and the Jacobian is taken with respect to ``x`` alone. Where
    one argument is per point, the other is broadcast to it.
    """
    tr = _transition(cfg)
    x_ref = _as(cfg, state, torch.zeros(cfg.xdim) if x_ref is None else x_ref)
    if cfg.udim > 0:
        if u_ref is None:
            raise ValueError(
                f"this model has udim={cfg.udim}: the transition features "
                "run over cat(x, u), so smoothing/linearization needs the "
                "control sequence — pass us= (core) / u= (facade)"
            )
        u_ref = _as(cfg, state, u_ref)
    else:
        # width-0 controls: one uniform (x, u) code path below
        u_ref = torch.zeros((0,), dtype=cfg.tdtype, device=_device(state))

    def mean_fn(x, u):
        return tr.transition_gaussian(state.dynamics, x[None, :], u[None, :], cfg.leak).mean[0]

    if x_ref.ndim == 1 and u_ref.ndim == 1:
        a = torch.func.jacfwd(mean_fn)(x_ref, u_ref)
        return a, mean_fn(x_ref, u_ref) - a @ x_ref
    lead = max(x_ref.shape[:-1], u_ref.shape[:-1], key=len)
    xr = _lead(x_ref, lead).reshape(-1, cfg.xdim)
    ur = _lead(u_ref, lead).reshape(xr.shape[0], u_ref.shape[-1])
    a = torch.func.vmap(torch.func.jacfwd(mean_fn))(xr, ur)
    c = torch.func.vmap(mean_fn)(xr, ur) - (a @ xr[..., None])[..., 0]
    return a.reshape(lead + a.shape[1:]), c.reshape(lead + c.shape[1:])


def _linearize_for_sequence(
    cfg: VJFConfig,
    state: TrainState,
    x_ref,
    t_len: int,
    us=None,
    batch: Tuple[int, ...] = (),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Linearization for (T, *batch) sequences: a ``(T, *batch, xdim)``
    reference trajectory (e.g. the filter's posterior means) linearizes the
    transition INTO step t at ``x_ref[t-1]`` (the prior mean for t = 0); a
    single point or None gives the global affine model.

    ``us``: the controls, required when ``cfg.udim > 0``: (T, udim), or
    (T, *batch, udim) per trial. ``us[t]`` drives the transition into step t
    (the filter's alignment), so it pairs with ``x_ref[t-1]`` unshifted.
    """
    if cfg.udim > 0:
        if us is None:
            raise ValueError(
                f"this model has udim={cfg.udim}: pass the (T, udim) "
                "control sequence (us= / facade u=) to smooth it"
            )
        us = _as(cfg, state, us)
        if us.shape not in ((t_len, cfg.udim), (t_len,) + tuple(batch) + (cfg.udim,)):
            raise ValueError(
                f"us must be (T, udim)=({t_len}, {cfg.udim}); got {tuple(us.shape)}"
            )
    else:
        us = None
    if x_ref is None:
        return linearize_dynamics(cfg, state, None, u_ref=us)
    x_ref = _as(cfg, state, x_ref)
    if x_ref.ndim == 1:
        return linearize_dynamics(cfg, state, x_ref, u_ref=us)
    if x_ref.shape != (t_len,) + tuple(batch) + (cfg.xdim,):
        raise ValueError(
            f"x_ref must be (xdim,) or (T, xdim)=({t_len}, {cfg.xdim}); "
            f"got {tuple(x_ref.shape)}"
        )
    prior = state.params.prior.mean.expand((1,) + x_ref.shape[1:])
    return linearize_dynamics(cfg, state, torch.cat([prior, x_ref[:-1]]), u_ref=us)


def _mask_promote(channel_mask, ys: torch.Tensor) -> torch.Tensor:
    """A (T, ydim) mask shared over trials, or (T, *batch, ydim), as
    ``ys``'s shape and dtype."""
    cm = torch.as_tensor(channel_mask).to(dtype=ys.dtype, device=ys.device)
    if cm.ndim == 1:
        cm = cm[None]
    return pkalman._seq(cm, ys.shape[0], tuple(ys.shape[1:-1]), 1)


def _ingest(cfg: VJFConfig, state: TrainState, ys) -> torch.Tensor:
    return wire_ingest(ys, cfg.tdtype, _device(state))


@full_f32_matmul()
def smooth(
    cfg: VJFConfig,
    state: TrainState,
    ys,
    x_ref=None,
    channel_mask=None,
    us=None,
) -> Tuple[pkalman.FilterResult, pkalman.SmoothResult]:
    """Parallel RTS smoothing of one observation sequence (T, ydim).

    Gaussian likelihood (Poisson dispatches to :func:`smooth_poisson`, the
    iterated-Laplace variant). ``x_ref`` sets the linearization: one
    ``(xdim,)`` point (default origin) or a ``(T, xdim)`` reference
    trajectory for per-step affine dynamics. ``us``: (T, udim) controls,
    required when ``cfg.udim > 0``. ``channel_mask``: optional (T, ydim) 0/1
    missing-observation mask: masked entries get infinite observation
    variance (exactly zero Kalman gain) and may hold NaN.
    """
    if cfg.likelihood == "poisson":
        return smooth_poisson(cfg, state, ys, x_ref=x_ref, channel_mask=channel_mask, us=us)
    if cfg.likelihood != "gaussian":
        raise NotImplementedError(f"unknown likelihood {cfg.likelihood}")
    ys = _ingest(cfg, state, ys)
    if ys.ndim != 2:
        raise ValueError("smooth() takes one (T, ydim) sequence")
    return _smooth_gaussian(cfg, state, ys, 1, x_ref, channel_mask, us)


def _system_matrices(cfg: VJFConfig, state: TrainState, with_r: bool = True):
    """Shared LGSSM pieces. ``with_r=False`` for the Poisson/Laplace path,
    whose working observation variance is per step."""
    dt, dev = cfg.tdtype, _device(state)
    q = torch.exp(state.dynamics.logvar) * torch.eye(cfg.xdim, dtype=dt, device=dev)
    h = state.params.decoder.weight                       # (ydim, xdim)
    r = None
    if with_r:
        r = torch.exp(state.params.likelihood.logvar) * torch.eye(cfg.ydim, dtype=dt, device=dev)
    m0 = state.params.prior.mean
    p0 = torch.diag(torch.exp(state.params.prior.logvar))
    return q, h, r, m0, p0


def _smooth_affine(cfg, state, ys, a, c, channel_mask=None):
    """The parallel smoother for (possibly per-step) affine dynamics. With
    ``channel_mask`` the diagonal-R information form runs: masked entries get
    infinite variance, exactly zero gain, and may hold NaN; without, the
    dense-R form."""
    q, h, r, m0, p0 = _system_matrices(cfg, state)
    y_eff = ys - state.params.decoder.bias
    if channel_mask is None:
        return pkalman.parallel_smooth(a, q, h, r, m0, p0, y_eff, b=c)
    cm = _mask_promote(channel_mask, ys)
    r_diag = torch.where(cm > 0, torch.exp(state.params.likelihood.logvar), torch.inf)
    return pkalman.parallel_smooth(a, q, h, r_diag, m0, p0, y_eff, b=c, diag_r=True)


def _smooth_gaussian(cfg, state, ys, n_iter, x_ref, channel_mask, us):
    """``n_iter`` passes of the Gaussian smoother on (T, *batch, ydim): the
    first at ``x_ref``'s linearization, each later one relinearized along
    the previous smoothed means."""
    t_len, batch = ys.shape[0], tuple(ys.shape[1:-1])
    a, c = _linearize_for_sequence(cfg, state, x_ref, t_len, us=us, batch=batch)
    filtered, smoothed = _smooth_affine(cfg, state, ys, a, c, channel_mask=channel_mask)
    for _ in range(n_iter - 1):
        a, c = _linearize_for_sequence(cfg, state, smoothed.means, t_len, us=us, batch=batch)
        filtered, smoothed = _smooth_affine(cfg, state, ys, a, c, channel_mask=channel_mask)
    return filtered, smoothed


@full_f32_matmul()
def smooth_poisson(
    cfg: VJFConfig,
    state: TrainState,
    ys,
    n_iter: int = 8,
    x_ref=None,
    relinearize_dynamics: bool = True,
    channel_mask=None,
    us=None,
) -> Tuple[pkalman.FilterResult, pkalman.SmoothResult]:
    """Iterated Laplace (EKS-style) parallel smoothing for the POISSON
    likelihood.

    ``y_t ~ Poisson(exp(eta_t))`` with ``eta = C x + d``: the Laplace
    approximation of the log-likelihood around the current ``eta_hat`` is the
    Gaussian working observation of the canonical log link::

        y_tilde = eta_hat + (y - lambda_hat) / lambda_hat,
        R_tilde = diag(1 / lambda_hat),       lambda_hat = exp(eta_hat)

    Each pass runs the parallel smoother on the working observations, then
    relinearizes ``eta_hat = C m_smoothed + d`` and, with
    ``relinearize_dynamics``, the dynamics along the smoothed means.

    ``channel_mask``: optional (T, ydim) 0/1: a masked count contributes
    nothing (infinite working variance) and may be NaN. ``us``: (T, udim)
    controls, required when ``cfg.udim > 0``; every relinearization uses
    them.
    """
    if n_iter < 1:
        raise ValueError(f"smooth_poisson: n_iter must be >= 1, got {n_iter}")
    ys = _ingest(cfg, state, ys)
    if ys.ndim != 2:
        raise ValueError("smooth_poisson() takes one (T, ydim) sequence")
    return _smooth_poisson(cfg, state, ys, n_iter, x_ref, relinearize_dynamics,
                           channel_mask, us)


def _smooth_poisson(cfg, state, ys, n_iter, x_ref, relinearize_dynamics, channel_mask, us):
    """:func:`smooth_poisson` on (T, *batch, ydim)."""
    t_len, batch = ys.shape[0], tuple(ys.shape[1:-1])
    cm = None if channel_mask is None else _mask_promote(channel_mask, ys)
    if cm is not None:
        ys = torch.where(cm > 0, ys, 0.0)                       # NaN-safe
    c_mat, d_vec = state.params.decoder.weight, state.params.decoder.bias
    q, _, _, m0, p0 = _system_matrices(cfg, state, with_r=False)

    def one_pass(eta_hat, a_seq, c_seq):
        lam = torch.clamp(torch.exp(torch.clamp(eta_hat, max=cfg.poisson_clamp)), min=1e-4)
        y_work = eta_hat + (ys - lam) / lam - d_vec              # observations of C x
        r_diag = 1.0 / lam
        if cm is not None:
            # missing counts: infinite working variance, exactly zero gain
            y_work = torch.where(cm > 0, y_work, 0.0)
            r_diag = torch.where(cm > 0, r_diag, torch.inf)
        filtered, smoothed = pkalman.parallel_smooth(a_seq, q, c_mat, r_diag, m0, p0, y_work,
                                                     b=c_seq, diag_r=True)
        return filtered, smoothed, smoothed.means @ c_mat.T + d_vec

    a_seq, c_seq = _linearize_for_sequence(cfg, state, x_ref, t_len, us=us, batch=batch)
    # the working response starts at log(y + 0.5), which keeps lambda_hat
    # sane for zero counts before the first pass
    eta_hat = torch.log(ys + 0.5)
    for i in range(n_iter):
        if i and relinearize_dynamics:
            a_seq, c_seq = _linearize_for_sequence(cfg, state, smoothed.means, t_len, us=us,
                                                   batch=batch)
        filtered, smoothed, eta_hat = one_pass(eta_hat, a_seq, c_seq)
    return filtered, smoothed


@full_f32_matmul()
def smooth_batch(
    cfg: VJFConfig,
    state: TrainState,
    ys,
    x_ref=None,
    channel_mask=None,
    n_iter: Optional[int] = None,
    mesh=None,
    us=None,
) -> Tuple[pkalman.FilterResult, pkalman.SmoothResult]:
    """Post-hoc smoothing of ``(T, B, ydim)`` trials in one batched call: the
    counterpart of the JAX package's ``vmap`` of :func:`smooth_iterated`
    over trials (the trials are independent given the trained model).
    ``n_iter=None`` takes :func:`smooth`'s defaults (one Gaussian pass,
    eight Poisson Laplace passes); a value iterates the relinearization as
    :func:`smooth_iterated` does.

    ``x_ref``: optional (T, B, xdim) per-trial linearization trajectories
    (e.g. ``FitResult.mu``). ``us``: (T, B, udim) per trial or (T, udim)
    shared, required when ``cfg.udim > 0``. ``channel_mask``: (T, ydim)
    shared over trials or (T, B, ydim) per trial.

    ``mesh``: a ``dp`` process group (``parallel.make_dp_group``) or a mesh
    (``parallel.make_mesh``, its ``dp`` axis). Every
    rank passes the same state and the whole batch; when B divides over the
    ranks each rank smooths its slice of the trials (``[r B/n, (r + 1)
    B/n)``, with its rows of ``x_ref``, a per-trial ``channel_mask`` and
    ``us``) and the results are gathered, so every rank returns the whole
    batch; otherwise every rank smooths the whole batch, as the JAX package
    does when the trials do not divide.

    The returned covariances are (T, B, xdim, xdim), twice over.
    """
    if mesh is not None:
        from ..parallel.sharded import _rank_and_size

        rank, world = _rank_and_size(mesh)
    if n_iter is None:
        n_iter = 8 if cfg.likelihood == "poisson" else 1
    ys = _ingest(cfg, state, ys)
    if ys.ndim != 3:
        raise ValueError(
            "smooth_batch() takes (T, B, ydim) trials; use smooth() for a "
            "single sequence"
        )
    t_len, n_batch, _ = ys.shape
    if x_ref is not None:
        x_ref = _as(cfg, state, x_ref)
        if x_ref.shape != (t_len, n_batch, cfg.xdim):
            raise ValueError(
                f"smooth_batch: x_ref must be (T, B, xdim) = "
                f"{(t_len, n_batch, cfg.xdim)}, got {tuple(x_ref.shape)}"
            )
    if channel_mask is not None:
        channel_mask = torch.as_tensor(channel_mask)
        if channel_mask.ndim == 3:
            if channel_mask.shape != ys.shape:
                raise ValueError(
                    f"smooth_batch: 3-d channel_mask must match ys "
                    f"{tuple(ys.shape)}, got {tuple(channel_mask.shape)}"
                )
        elif channel_mask.shape != (t_len, cfg.ydim):
            raise ValueError(
                "smooth_batch: channel_mask must be (T, ydim) shared or "
                f"(T, B, ydim) per-trial, got {tuple(channel_mask.shape)}"
            )
    if cfg.udim > 0 and us is None:
        raise ValueError(
            f"this model has udim={cfg.udim}: pass the control sequence "
            "us= ((T, B, udim) per-trial or (T, udim) shared) to smooth it"
        )
    if us is not None:
        us = _as(cfg, state, us)
        if us.ndim == 3:
            if us.shape != (t_len, n_batch, cfg.udim):
                raise ValueError(
                    f"smooth_batch: 3-d us must be (T, B, udim) = "
                    f"{(t_len, n_batch, cfg.udim)}, got {tuple(us.shape)}"
                )
        elif us.shape != (t_len, cfg.udim):
            raise ValueError(
                "smooth_batch: us must be (T, udim) shared or (T, B, udim) "
                f"per-trial, got {tuple(us.shape)}"
            )
    if mesh is None or n_batch % world:
        return _smooth_iterated(cfg, state, ys, n_iter, x_ref, channel_mask, us)
    from ..parallel.sharded import gather_rows

    rows = slice(rank * (n_batch // world), (rank + 1) * (n_batch // world))

    def cut(v):
        return v[:, rows] if v is not None and v.ndim == 3 else v

    filtered, smoothed = _smooth_iterated(cfg, state, ys[:, rows], n_iter, cut(x_ref),
                                          cut(channel_mask), cut(us))
    return (pkalman.FilterResult(*(gather_rows(t, mesh, 1) for t in filtered)),
            pkalman.SmoothResult(*(gather_rows(t, mesh, 1) for t in smoothed)))


def _smooth_iterated(cfg, state, ys, n_iter, x_ref, channel_mask, us):
    """:func:`smooth_iterated` on (T, *batch, ydim)."""
    if n_iter < 1:
        raise ValueError(f"smooth_iterated: n_iter must be >= 1, got {n_iter}")
    if cfg.likelihood == "poisson":
        return _smooth_poisson(cfg, state, ys, n_iter, x_ref, True, channel_mask, us)
    if cfg.likelihood != "gaussian":
        raise NotImplementedError(f"unknown likelihood {cfg.likelihood}")
    return _smooth_gaussian(cfg, state, ys, n_iter, x_ref, channel_mask, us)


@full_f32_matmul()
def smooth_iterated(
    cfg: VJFConfig,
    state: TrainState,
    ys,
    n_iter: int = 3,
    x_ref=None,
    channel_mask=None,
    us=None,
) -> Tuple[pkalman.FilterResult, pkalman.SmoothResult]:
    """Iterated extended smoothing: relinearize the learned velocity field
    along the previous smoothed trajectory (per-step A_t, c_t) and run the
    parallel smoother again, ``n_iter`` passes in all.

    Poisson dispatches to :func:`smooth_poisson` with the same ``n_iter``:
    its Laplace loop already relinearizes the dynamics each pass, plus the
    observations (so ``n_iter=1`` is one Laplace pass)."""
    if n_iter < 1:
        raise ValueError(f"smooth_iterated: n_iter must be >= 1, got {n_iter}")
    if cfg.likelihood == "poisson":
        return smooth_poisson(cfg, state, ys, n_iter=n_iter, x_ref=x_ref,
                              channel_mask=channel_mask, us=us)
    ys = _ingest(cfg, state, ys)
    if ys.ndim != 2:
        raise ValueError("smooth() takes one (T, ydim) sequence")
    return _smooth_iterated(cfg, state, ys, n_iter, x_ref, channel_mask, us)
