"""The whole VJF filter-then-learn step, as hand-written CUDA kernels and
their plain PyTorch versions (counterpart of
``vjf_tpu/ops/pallas/fused_step.py``).

* :func:`step_forward_sums` + :func:`step_apply`, composed by
  :func:`step_math`, are the step as plain tensor code. They are the
  specification the kernels are held to, and what runs on CPU tensors.
* :func:`fused_step_call` runs one step (the exact-inverse prefix) and
  :func:`mega_epoch_call` runs a whole segment of steps in one launch.
  :func:`forward_sums_call` runs phase 1 of the sharded step alone (the
  counterpart of the JAX ``forward_sums_call``): forward, backward and the
  trial sums into one flat buffer (:func:`pack_sums`) that a single
  all-reduce adds up across ranks. On a CUDA tensor each launches its kernel
  from ``csrc/fused_step.cu`` (``vjf_fused_step``, ``vjf_mega_epoch``,
  ``vjf_forward_sums``) or raises; on a CPU tensor each runs its plain
  version. Each kernel runs as one thread-block cluster that splits the
  trials and the rows of P, V and w (:func:`cluster_rows` mirrors the split).
* :func:`run_epoch_fused` pads the state once, runs the prefix (per-step
  kernel plus :func:`exact_v_fallback`) and the mega segment, and unpads.
  The sharded epoch, ``parallel.sharded.run_epoch_fused_sharded``, runs
  :func:`forward_sums_call`, the all-reduce, :func:`step_apply` without
  per-trial inputs and :func:`exact_v_fallback_sums` per step.

Numerics follow the JAX package: with ``matmul_dtype='bfloat16'`` the
activation, gradient and statistics products round their inputs to bf16 and
accumulate in f32 (:func:`_mm_fn`); the feedback chain (``P w``, every
Newton-Schulz product, ``V g``, the RBF cross term) stays full f32, and so
does the SGP whitening product (``feat @ w_white``).

With SGP dynamics (``cfg.dynamics='sgp'``) the carry holds the whitener
``w_white = scale^2 W`` and ``scale2``: the unit SE response at the inducing
points is whitened before it feeds the prediction and the RLS statistics,
and the predictive log-variance adds the DTC correction ``max(scale^2 -
|phi|^2, 0)``. The kernels take any multiple of 128 padded features, any
number of hidden layers of any width and any number of trials, as long as a
block's shared memory fits the card's at the smallest plan
(:func:`kernel_limits`; ``plan_tiles`` in csrc/fused_step.cu: a block runs
phase 1 over tiles of its trials where all of them do not fit, and stages
the Newton-Schulz right-hand matrix in chunks past 128 padded features;
where no tile fits so, the L2 route keeps every trial's posterior, noise and
mask column and phase 2's P_new and V_new rows in the L2 workspace and
stages the left operand of each Newton-Schulz product in sub-panels: at the
flagship widths up to 1,792 padded features and any number of trials;
:func:`cluster_info` reports the plan of a launch); under
``fused_step='auto'`` a configuration past a limit takes the autograd
epoch.

Ragged trials and missing channels: every step function and launcher takes
a trial mask (``mask``: per trial, 0 or 1) and a channel mask (``cmask``: per
trial and channel), as the JAX package's do. Masked entries of ``y`` and
``u`` are replaced by select (channel holes first, then masked trials), so
they may hold NaN; a masked trial leaves every batch sum, which is
renormalised over the valid count, and its posterior is frozen at its last
valid value; a step with no valid trial advances nothing and reports loss
and tau 0; a masked channel leaves the likelihood sum and the recognition
input sees the decoder's prediction there (:func:`step_forward_sums`).
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import logging
import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..config import StepFlags, VJFConfig
from . import rng as _rng
from . import trace as _trace
from .trace import launches, reset_launches, steps  # noqa: F401  (the launch counters)

NS_ITERS = 3
NS_TAU_THRESHOLD = 0.25
NS_TAU_MAX = 0.7
NS_EXTRA_ITERS = 2
NS_TAU_ESCALATE = 0.05
NS_ONE_ITER_MIN_BATCH = 64

logger = logging.getLogger(__name__)


def prefix_free_next(current: bool, hot_max: float, tau_max: float) -> bool:
    """Next dispatch's prefix-free decision from a watched block's tau
    statistics (``cfg.ns_prefix_free``): engage below the in-kernel
    escalation threshold, where the per-step and mega kernels compute alike;
    revoke on any hot step or on a tau in the exact-fallback band; hold in
    between, where the escalation handles it."""
    if hot_max > 0 or tau_max >= NS_TAU_THRESHOLD:
        return False
    if tau_max < NS_TAU_ESCALATE:
        return True
    return current


def epoch_repair_enabled(cfg, n_batch: int) -> bool:
    """Resolve ``cfg.rls_epoch_repair``: 'auto' repairs small-batch epochs."""
    mode = cfg.rls_epoch_repair
    if mode not in ("auto", "on", "off"):
        raise ValueError(
            f"rls_epoch_repair must be 'auto', 'on', or 'off' (got {mode!r})"
        )
    if mode == "on":
        return True
    if mode == "off":
        return False
    return n_batch < NS_ONE_ITER_MIN_BATCH


def maybe_epoch_repair(cfg, flags, state, n_batch: int):
    """Epoch-boundary spectral repair of the tracked (P, V) pair, if this
    epoch is RLS-active, ``cfg.rls_epoch_repair`` resolves enabled and the
    state carries the nsv form. Runs on the UNPADDED state."""
    do_fallback = flags.update and flags.update_transition and not flags.warm_up
    if not (do_fallback and epoch_repair_enabled(cfg, n_batch)):
        return state
    from ..models import regression as _reg

    if not isinstance(state.dynamics.blr, _reg.NSVBLR):
        return state
    return state._replace(
        dynamics=state.dynamics._replace(
            blr=_reg.spectral_repair(
                state.dynamics.blr,
                only_if_indefinite=cfg.rls_epoch_repair != "on",
            )
        )
    )


def _round_up(x: int, m: int = 128) -> int:
    return ((x + m - 1) // m) * m


class FusedCarry(NamedTuple):
    """Kernel-layout training state (padded, biases 2D, weights pre-split)."""

    w_in_y: torch.Tensor                  # (h0, yd)
    w_in_u: Optional[torch.Tensor]        # (h0, ud) or None when udim == 0
    w_in_m: torch.Tensor                  # (h0, xd)
    w_in_lv: torch.Tensor                 # (h0, xd)
    w_hidden: Tuple[torch.Tensor, ...]    # each (h_i, h_{i-1}), layers 1..
    b_hidden: Tuple[torch.Tensor, ...]    # each (1, h_i), layers 0..
    w_mean: torch.Tensor                  # (xd, h_last)
    w_logvar: torch.Tensor                # (xd, h_last)
    b_logvar: torch.Tensor                # (1, xd)
    w_dec: torch.Tensor                   # (yd, xd)
    b_dec: torch.Tensor                   # (1, yd)
    cent_x: torch.Tensor                  # (nfp, xd), pad rows at +1e6
    cent_u: Optional[torch.Tensor]        # (nfp, ud) or None
    c2: torch.Tensor                      # (1, nfp) sum of squared centroid coords
    inv_w2: torch.Tensor                  # (1, nfp) exp(-2 logwidth)
    w_white: Optional[torch.Tensor]       # SGP: (nfp, nfp) scale^2 W, zero pad; rbf: None
    scale2: Optional[torch.Tensor]        # SGP: (1, 1) scale^2; rbf: None
    p_mat: torch.Tensor                   # (nfp, nfp) precision, identity pad block
    v_mat: torch.Tensor                   # (nfp, nfp) NS-tracked inverse
    w_dyn: torch.Tensor                   # (nfp, xd), zero pad rows
    state_logvar: torch.Tensor            # (1, 1) each
    lik_logvar: torch.Tensor
    dyn_n: torch.Tensor
    lik_n: torch.Tensor
    rng_seed: torch.Tensor                # (1, 1) int32 Philox key
    rng_count: torch.Tensor               # (1, 1) int32 per-step counter


class ScalarPack(NamedTuple):
    loss: torch.Tensor                    # (1, 1) each
    recon: torch.Tensor
    dyn: torch.Tensor
    ent: torch.Tensor
    tau: torch.Tensor


class StepOut(NamedTuple):
    carry: FusedCarry
    qt_mean: torch.Tensor
    qt_logvar: torch.Tensor
    g_vec: torch.Tensor                   # (nfp, xd) RLS target
    xt: torch.Tensor                      # (B, xd)
    xs: torch.Tensor                      # (B, xd)
    scal: ScalarPack


class FusedSums(NamedTuple):
    """Everything the step needs from the batch, reduced over trials."""

    g_w_in_y: torch.Tensor
    g_w_in_u: Optional[torch.Tensor]
    g_w_in_m: torch.Tensor
    g_w_in_lv: torch.Tensor
    g_w_hidden: Tuple[torch.Tensor, ...]
    g_b_hidden: Tuple[torch.Tensor, ...]
    g_w_mean: torch.Tensor
    g_w_logvar: torch.Tensor
    g_b_logvar: torch.Tensor
    g_w_dec: torch.Tensor
    g_b_dec: torch.Tensor
    g_lik_lv_batch: torch.Tensor
    recon_batch: torch.Tensor
    dyn_batch: torch.Tensor
    ent: torch.Tensor
    sq_y: torch.Tensor
    # sum over every gradient entry: non-finite iff any entry is
    grad_check: torch.Tensor
    ftf_raw: torch.Tensor
    fxd_raw: torch.Tensor
    fvf_sum: torch.Tensor
    dx_sum: torch.Tensor
    dx2_sum: torch.Tensor
    # the count of observed (channel x trial mask) entries of y, or None
    # without a channel mask: the Gaussian log-variance constant and the
    # fractional obs-noise count need it
    cm_sum: Optional[torch.Tensor] = None


class PerTrial(NamedTuple):
    qt_m: torch.Tensor
    qt_lv: torch.Tensor
    xt: torch.Tensor
    xs: torch.Tensor
    feat: torch.Tensor
    dx: torch.Tensor


def _mm_fn(cfg: VJFConfig, dtype: torch.dtype):
    """Products of activations, gradients and statistics: bf16 inputs with
    f32 accumulation when ``matmul_dtype='bfloat16'`` (``a.bfloat16() @
    b.bfloat16()`` would round the RESULT to bf16 too, so the inputs are
    rounded and brought back to f32 first)."""
    if cfg.matmul_dtype == "bfloat16" and dtype == torch.float32:
        def mm(a, b):
            return a.bfloat16().float() @ b.bfloat16().float()
        return mm
    return torch.matmul


def _mask_col(mask: torch.Tensor, dtype) -> torch.Tensor:
    """A (B,) or (B, 1) trial mask as a (B, 1) column of exact 0/1."""
    return (mask.reshape(-1, 1) > 0).to(dtype)


def step_forward_sums(
    cfg: VJFConfig,
    flags: StepFlags,
    carry: FusedCarry,
    qs_m: torch.Tensor,
    qs_lv: torch.Tensor,
    y: torch.Tensor,
    u: Optional[torch.Tensor],
    eps_s: torch.Tensor,
    eps_t: torch.Tensor,
    inv_b,
    mask: Optional[torch.Tensor] = None,
    cmask: Optional[torch.Tensor] = None,
    local_renorm: bool = True,
) -> Tuple[FusedSums, PerTrial]:
    """Per-trial phase of the step: forward pass, hand-written backward and
    trial-axis reductions, every batch mean scaled by ``inv_b``. With SGP
    the features are whitened (full f32) and the predictive log-variance
    carries the DTC correction.

    ``mask`` (B,) or (B, 1), 0/1: masked rows of ``y`` and ``u`` are
    replaced by 0 (select: NaN padding stays out), and the rows leave every
    sum (loss, gradients, RLS statistics). With ``local_renorm`` the batch
    means divide by this call's valid count; a sharded caller passes
    ``local_renorm=False`` and the global ``1 / max(count, 1)`` as
    ``inv_b``. ``cmask`` (B, ydim), 0/1: masked entries of ``y`` become 0
    (before the trial mask), leave the likelihood sum and its gradient, and
    the recognition input sees the decoder's prediction from ``qs_m``
    there (the count scale for Poisson); ``sums.cm_sum`` counts the
    observed entries."""
    f32 = qs_m.dtype
    slogvar = carry.state_logvar[0, 0]
    has_u = u is not None and u.shape[-1] > 0
    mm = _mm_fn(cfg, f32)
    zero = torch.zeros((), dtype=f32, device=y.device)
    m_col = cm_eff = cm = cm_sum = None
    if cmask is not None:
        cm = (cmask > 0).to(f32)
        y = torch.where(cm > 0, y, zero)
    if mask is not None:
        m_col = _mask_col(mask, f32)
        y = torch.where(m_col > 0, y, zero)
        if has_u:
            u = torch.where(m_col > 0, u, zero)
        if local_renorm:
            inv_b = 1.0 / torch.clamp(torch.sum(m_col), min=1.0)
    if cmask is not None:
        # a masked trial's entries leave the channel statistics too
        cm_eff = cm * m_col if m_col is not None else cm
        cm_sum = torch.sum(cm_eff)
    # the weights of the per-entry likelihood sums
    row_w = cm_eff if cm_eff is not None else m_col

    # ---------------- forward ----------------
    xs = qs_m + eps_s * torch.exp(0.5 * qs_lv)
    x2 = torch.sum(xs * xs, dim=-1, keepdim=True)             # (B, 1)
    cross = xs @ carry.cent_x.T                               # full precision
    if has_u:
        x2 = x2 + torch.sum(u * u, dim=-1, keepdim=True)
        cross = cross + u @ carry.cent_u.T
    d2 = torch.clamp(x2 + carry.c2 - 2.0 * cross, min=0.0)
    feat = torch.exp(-0.5 * d2 * carry.inv_w2)                # (B, nfp); pad cols 0
    if carry.w_white is not None:
        # SGP whitening in full f32: these features feed the RLS feedback chain
        feat = feat @ carry.w_white

    z = mm(feat, carry.v_mat)
    fvf = torch.clamp(torch.sum(z * feat, dim=-1, keepdim=True), min=1e-30)
    if carry.w_white is not None:
        dtc = torch.clamp(carry.scale2[0, 0] - torch.sum(feat * feat, dim=-1, keepdim=True),
                          min=0.0)
        pt_lv = torch.log(fvf + dtc + 1e-30)                  # (B, 1)
    else:
        pt_lv = torch.log(fvf)                                # (B, 1)
    pt_m = (1.0 - cfg.leak) * xs + mm(feat, carry.w_dyn)

    if cm is not None:
        # imputation for the recognition input only: the decoder's
        # prediction from the previous posterior mean; never differentiated
        pred = mm(qs_m, carry.w_dec.T) + carry.b_dec
        if cfg.likelihood == "poisson":
            pred = torch.exp(torch.clamp(pred, max=cfg.poisson_clamp))
        y_rec = torch.where(cm > 0, y, pred)
    else:
        y_rec = y
    a0 = mm(y_rec, carry.w_in_y.T) + mm(qs_m, carry.w_in_m.T) + mm(qs_lv, carry.w_in_lv.T)
    if has_u:
        a0 = a0 + mm(u, carry.w_in_u.T)
    a = torch.tanh(a0 + carry.b_hidden[0])
    hs = [a]
    for i, w in enumerate(carry.w_hidden):
        a = torch.tanh(mm(a, w.T) + carry.b_hidden[i + 1])
        hs.append(a)
    h_last = a
    qt_m = mm(h_last, carry.w_mean.T)
    raw_qt_lv = mm(h_last, carry.w_logvar.T) + carry.b_logvar
    qt_lv = torch.clamp(raw_qt_lv, -cfg.logvar_clamp, cfg.logvar_clamp)
    sig_t = torch.exp(0.5 * qt_lv)
    xt = qt_m + eps_t * sig_t
    py = mm(xt, carry.w_dec.T) + carry.b_dec

    # ---------------- ELBO batch sums ----------------
    if cfg.likelihood == "poisson":
        pyc = torch.clamp(py, max=cfg.poisson_clamp)
        exp_pyc = torch.exp(pyc)
        nll_rows = exp_pyc - y * pyc
        if row_w is not None:
            nll_rows = nll_rows * row_w
        recon_batch = torch.sum(nll_rows) * inv_b
        sq_y = zero
    else:
        lik_lv = carry.lik_logvar[0, 0]
        resid_y = y - py
        sq_rows = resid_y * resid_y
        if row_w is not None:
            sq_rows = sq_rows * row_w
        sq_y = torch.sum(sq_rows)
        recon_batch = zero

    inv_sv = torch.exp(-slogvar)
    diff = pt_m - qt_m
    if cfg.trace_quirk:
        trace = torch.exp(pt_lv + qt_lv - slogvar)
    else:
        trace = torch.exp(pt_lv - slogvar) + torch.exp(qt_lv - slogvar)
    diff2, ent_rows = diff * diff, qt_lv
    if m_col is not None:
        diff2, trace, ent_rows = diff2 * m_col, trace * m_col, ent_rows * m_col
    dyn_batch = torch.sum(diff2) * inv_sv * inv_b + torch.sum(trace) * inv_b
    h_ent = 0.5 * torch.sum(ent_rows) * inv_b

    # ---------------- manual backward (gradient batch-sums) ----------------
    nh = len(carry.w_hidden)
    if flags.sgd:
        if cfg.likelihood == "poisson":
            g_py = (exp_pyc - y) * (py < cfg.poisson_clamp) * inv_b
            g_lik_lv_batch = zero
        else:
            g_py = -resid_y * torch.exp(-lik_lv) * inv_b
            g_lik_lv_batch = -0.5 * sq_y * torch.exp(-lik_lv) * inv_b
        if row_w is not None:
            g_py = g_py * row_w

        g_xt = mm(g_py, carry.w_dec)                           # (B, xd)
        if flags.train_decoder:
            g_w_dec = mm(g_py.T, xt)
            g_b_dec = torch.sum(g_py, dim=0, keepdim=True)
        else:
            g_w_dec = torch.zeros_like(carry.w_dec)
            g_b_dec = torch.zeros_like(carry.b_dec)

        g_qt_m = g_xt
        g_qt_lv = g_xt * eps_t * (0.5 * sig_t) - (0.5 * inv_b)
        if not flags.warm_up:
            g_qt_m = g_qt_m - diff * (inv_sv * inv_b)
            if cfg.trace_quirk:
                g_qt_lv = g_qt_lv + 0.5 * trace * inv_b
            else:
                g_qt_lv = g_qt_lv + 0.5 * torch.exp(qt_lv - slogvar) * inv_b
        # nothing flows back through the logvar clip where it binds
        g_qt_lv = g_qt_lv * (torch.abs(raw_qt_lv) < cfg.logvar_clamp)
        if m_col is not None:
            g_qt_m, g_qt_lv = g_qt_m * m_col, g_qt_lv * m_col

        g_wm = mm(g_qt_m.T, h_last)
        g_wlv = mm(g_qt_lv.T, h_last)
        g_blv = torch.sum(g_qt_lv, dim=0, keepdim=True)
        g_h = mm(g_qt_m, carry.w_mean) + mm(g_qt_lv, carry.w_logvar)

        g_w_hidden = [None] * nh
        g_b_hidden = [None] * (nh + 1)
        for i in range(nh, 0, -1):                             # layers n..1
            h_i = hs[i]
            g_a = g_h * (1.0 - h_i * h_i)
            g_w_hidden[i - 1] = mm(g_a.T, hs[i - 1])
            g_b_hidden[i] = torch.sum(g_a, dim=0, keepdim=True)
            g_h = mm(g_a, carry.w_hidden[i - 1])
        g_a0 = g_h * (1.0 - hs[0] * hs[0])                     # first layer
        g_b_hidden[0] = torch.sum(g_a0, dim=0, keepdim=True)
        g_w_in_u = mm(g_a0.T, u) if has_u else None
        g_w_in_y = mm(g_a0.T, y_rec)          # the layer saw the imputed input
        g_w_in_m = mm(g_a0.T, qs_m)
        g_w_in_lv = mm(g_a0.T, qs_lv)
    else:
        g_w_in_y = torch.zeros_like(carry.w_in_y)
        g_w_in_u = torch.zeros_like(carry.w_in_u) if has_u else None
        g_w_in_m = torch.zeros_like(carry.w_in_m)
        g_w_in_lv = torch.zeros_like(carry.w_in_lv)
        g_w_hidden = [torch.zeros_like(w) for w in carry.w_hidden]
        g_b_hidden = [torch.zeros_like(bb) for bb in carry.b_hidden]
        g_wm = torch.zeros_like(carry.w_mean)
        g_wlv = torch.zeros_like(carry.w_logvar)
        g_blv = torch.zeros_like(carry.b_logvar)
        g_w_dec = torch.zeros_like(carry.w_dec)
        g_b_dec = torch.zeros_like(carry.b_dec)
        g_lik_lv_batch = zero

    # ---------------- RLS raw statistics ----------------
    dx = xt - xs
    if flags.update and flags.update_transition:
        if m_col is not None:
            # zeroed feature rows leave F^T F and F^T dx
            feat_s, dx_s = feat * m_col, dx * m_col
            dx_sum, dx2_sum = torch.sum(dx_s), torch.sum(dx_s * dx)
            fvf_sum = torch.sum(fvf * m_col)
        else:
            feat_s = feat
            dx_sum, dx2_sum, fvf_sum = torch.sum(dx), torch.sum(dx * dx), torch.sum(fvf)
        ftf_raw = mm(feat_s.T, feat_s)
        fxd_raw = mm(feat_s.T, dx)
    else:
        dx_sum = dx2_sum = fvf_sum = zero
        ftf_raw = torch.zeros_like(carry.p_mat)
        fxd_raw = torch.zeros_like(carry.w_dyn)

    if flags.sgd:
        grad_leaves = (
            [g_w_in_y, g_w_in_m, g_w_in_lv, g_wm, g_wlv, g_blv, g_w_dec,
             g_b_dec, g_lik_lv_batch]
            + ([g_w_in_u] if has_u else [])
            + list(g_w_hidden) + list(g_b_hidden)
        )
        grad_check = sum(torch.sum(g) for g in grad_leaves)
    else:
        grad_check = zero

    sums = FusedSums(
        g_w_in_y=g_w_in_y, g_w_in_u=g_w_in_u, g_w_in_m=g_w_in_m,
        g_w_in_lv=g_w_in_lv,
        g_w_hidden=tuple(g_w_hidden), g_b_hidden=tuple(g_b_hidden),
        g_w_mean=g_wm, g_w_logvar=g_wlv, g_b_logvar=g_blv,
        g_w_dec=g_w_dec, g_b_dec=g_b_dec, g_lik_lv_batch=g_lik_lv_batch,
        recon_batch=recon_batch, dyn_batch=dyn_batch, ent=h_ent, sq_y=sq_y,
        grad_check=grad_check,
        ftf_raw=ftf_raw, fxd_raw=fxd_raw, fvf_sum=fvf_sum,
        dx_sum=dx_sum, dx2_sum=dx2_sum, cm_sum=cm_sum,
    )
    per = PerTrial(qt_m=qt_m, qt_lv=qt_lv, xt=xt, xs=xs, feat=feat, dx=dx)
    return sums, per


def _ns_iter(x: torch.Tensor, p_new: torch.Tensor, eye2: torch.Tensor) -> torch.Tensor:
    return x @ (eye2 - p_new @ x)


def _stats_mse(sums: FusedSums, w: torch.Tensor, b) -> torch.Tensor:
    """``mean |dx - F w|^2`` over ``b`` trials from the summed statistics:
    ``(dx2 - 2 <w, F^T dx> + <w, F^T F w>) / (b xd)``, products in full
    precision. It cancels in f32 where the residual is small."""
    quad = torch.sum(w * (sums.ftf_raw @ w))
    return (sums.dx2_sum - 2.0 * torch.sum(w * sums.fxd_raw) + quad) / (b * w.shape[-1])


def step_apply(
    cfg: VJFConfig,
    flags: StepFlags,
    carry: FusedCarry,
    sums: FusedSums,
    lr: torch.Tensor,
    b_total: int,
    feat: Optional[torch.Tensor] = None,
    dx: Optional[torch.Tensor] = None,
    ns_extra=None,
    ns_tau_max: Optional[float] = None,
    ns_iters: int = NS_ITERS,
    mask: Optional[torch.Tensor] = None,
    valid_count: Optional[torch.Tensor] = None,
) -> Tuple[FusedCarry, ScalarPack, torch.Tensor]:
    """Batch-independent phase: reconstruct the ELBO from the sums, apply
    clipped SGD, then the closed-form updates (obs noise, RLS with
    Newton-Schulz tracking of V, state noise).

    ``feat``/``dx`` (per-trial) give the post-update residual directly on
    one device; without them (the sharded step, whose ``sums`` are
    all-reduced) its mean square comes from the summed statistics
    (:func:`_stats_mse`).

    ``mask``: the trial mask given to :func:`step_forward_sums` (one
    device); ``valid_count``: instead, the global valid count (a scalar
    tensor; the sharded step). Either makes every count and denominator the
    valid count; a step with no valid trial then leaves the loss at 0, the
    RLS recursion and the noise counters where they were. With
    ``sums.cm_sum`` (a channel mask) the Gaussian log-variance constant is
    per observed entry and the obs-noise count advances by ``cm_sum /
    ydim``."""
    f32 = carry.w_dyn.dtype
    dev = carry.w_dyn.device
    zero = torch.zeros((), dtype=f32, device=dev)
    m_col = None
    if mask is not None:
        m_col = _mask_col(mask, f32)
        count = torch.sum(m_col)               # the raw count, 0 allowed
    elif valid_count is not None:
        if feat is not None:
            raise ValueError("valid_count is the sharded mode: no per-trial feat/dx")
        count = valid_count.to(f32)
    else:
        count = b_total
    masked = mask is not None or valid_count is not None
    if masked:
        b = torch.clamp(count, min=1.0)        # the guarded divisor
        has_data = count > 0
    else:
        b = b_total
    inv_b = 1.0 / b
    has_cm = sums.cm_sum is not None
    slogvar = carry.state_logvar[0, 0]
    mm = _mm_fn(cfg, f32)
    ydim = carry.w_dec.shape[0]
    xd = carry.w_dyn.shape[-1]

    # ---------------- ELBO components with their constants ----------------
    if cfg.likelihood == "poisson":
        l_recon = sums.recon_batch
        obs_mse = zero
    else:
        lik_lv = carry.lik_logvar[0, 0]
        if has_cm:
            # the log-variance constant per observed entry; the mse over them
            l_recon = 0.5 * (sums.sq_y * torch.exp(-lik_lv) * inv_b
                             + sums.cm_sum * inv_b * lik_lv)
            obs_mse = sums.sq_y / torch.clamp(sums.cm_sum, min=1.0)
        else:
            l_recon = 0.5 * (sums.sq_y * torch.exp(-lik_lv) * inv_b + ydim * lik_lv)
            obs_mse = sums.sq_y * inv_b / ydim
    l_dyn = 0.5 * (sums.dyn_batch + xd * slogvar)
    h_ent = sums.ent
    if masked:
        # no data, no loss: the constants would survive an empty step
        l_recon = torch.where(has_data, l_recon, zero)
        l_dyn = torch.where(has_data, l_dyn, zero)
        h_ent = torch.where(has_data, h_ent, zero)

    # the skip-step gate sees the RAW components; in warm-up the dynamics
    # term is outside the loss, so it does not gate
    raw_ok = torch.isfinite(l_recon) & torch.isfinite(h_ent)
    if not flags.warm_up:
        raw_ok = raw_ok & torch.isfinite(l_dyn)
    l_recon = torch.where(torch.isfinite(l_recon), l_recon, zero)
    l_dyn = torch.where(torch.isfinite(l_dyn), l_dyn, zero)
    h_ent = torch.where(torch.isfinite(h_ent), h_ent, zero)
    loss = l_recon - h_ent + (0.0 if flags.warm_up else l_dyn)

    # ---------------- clipped SGD ----------------
    new = carry
    if flags.sgd:
        sgd_ok = raw_ok & torch.isfinite(sums.grad_check)
        clip = cfg.clip

        def upd(p, g):
            # select, don't scale: 0 * NaN = NaN would poison the params
            return torch.where(sgd_ok, p - lr * torch.clamp(g, -clip, clip), p)

        if cfg.likelihood == "poisson":
            lik_logvar_new = carry.lik_logvar
        else:
            # d(0.5 ydim lik_lv)/d(lik_lv); per observed entry under a
            # channel mask, 0 on a step without data
            if has_cm:
                g_lv_const = 0.5 * sums.cm_sum * inv_b
            elif masked:
                g_lv_const = torch.where(has_data, torch.full_like(zero, 0.5 * ydim), zero)
            else:
                g_lv_const = 0.5 * ydim
            lik_logvar_new = upd(carry.lik_logvar, sums.g_lik_lv_batch + g_lv_const)
        if flags.train_decoder:
            w_dec_new = upd(carry.w_dec, sums.g_w_dec)
            b_dec_new = upd(carry.b_dec, sums.g_b_dec)
        else:
            w_dec_new, b_dec_new = carry.w_dec, carry.b_dec
        new = new._replace(
            w_in_y=upd(carry.w_in_y, sums.g_w_in_y),
            w_in_u=upd(carry.w_in_u, sums.g_w_in_u)
            if sums.g_w_in_u is not None
            else carry.w_in_u,
            w_in_m=upd(carry.w_in_m, sums.g_w_in_m),
            w_in_lv=upd(carry.w_in_lv, sums.g_w_in_lv),
            w_hidden=tuple(upd(w, g) for w, g in zip(carry.w_hidden, sums.g_w_hidden)),
            b_hidden=tuple(upd(bb, g) for bb, g in zip(carry.b_hidden, sums.g_b_hidden)),
            w_mean=upd(carry.w_mean, sums.g_w_mean),
            w_logvar=upd(carry.w_logvar, sums.g_w_logvar),
            b_logvar=upd(carry.b_logvar, sums.g_b_logvar),
            w_dec=w_dec_new,
            b_dec=b_dec_new,
            lik_logvar=lik_logvar_new,
        )

    # ---------------- non-gradient updates ----------------
    tau = torch.zeros((), dtype=f32, device=dev)
    g_vec = torch.zeros_like(carry.w_dyn)
    if flags.update and cfg.likelihood == "gaussian" and flags.update_likelihood:
        # running-var overwrite with the POST-SGD logvar
        # the raw valid count, or under a channel mask the fractional rows
        adv = sums.cm_sum / ydim if has_cm else count
        lik_n = torch.clamp(new.lik_n[0, 0], max=float(cfg.obs_var_cap))
        tot = lik_n + adv
        var = (lik_n / tot) * torch.exp(new.lik_logvar[0, 0]) + (adv / tot) * obs_mse
        lik_lv_new = torch.clamp(torch.log(var), -cfg.logvar_clamp, cfg.logvar_clamp)
        lik_ok = torch.isfinite(var)
        new = new._replace(
            lik_logvar=torch.where(lik_ok, lik_lv_new, new.lik_logvar[0, 0]).reshape(1, 1),
            lik_n=torch.where(lik_ok, tot, new.lik_n[0, 0]).reshape(1, 1),
        )

    if flags.update and flags.update_transition:
        dyn_ok = torch.isfinite(sums.dx_sum)
        if masked:
            # a step without data must not advance the recursion
            dyn_ok = dyn_ok & has_data
        w_dyn_new = carry.w_dyn
        if not flags.warm_up:
            lam = float(cfg.rls_shrink)
            jit_c = float(cfg.chol_jitter)
            inv_sv_u = torch.exp(-slogvar)
            ftf = sums.ftf_raw * inv_sv_u
            g_vec = lam * (carry.p_mat @ carry.w_dyn) + sums.fxd_raw * inv_sv_u
            p_new = lam * carry.p_mat + ftf
            nfp = carry.p_mat.shape[0]
            if lam != 1.0 or jit_c != 0.0:
                # the identity pad block stays EXACTLY identity; the real
                # block gets the per-step jitter ridge
                diag = torch.eye(nfp, dtype=f32, device=dev)
                rows = torch.arange(nfp, device=dev)[:, None]
                pad_diag = diag * (rows >= cfg.feature_dim).to(f32)
                p_new = p_new + (1.0 - lam) * pad_diag + jit_c * (diag - pad_diag)
            # tau = tr(dP V_old), the NS-residual trace bound
            tau = sums.fvf_sum * inv_sv_u / lam
            x_ns = carry.v_mat / lam if lam != 1.0 else carry.v_mat
            eye2 = 2.0 * torch.eye(nfp, dtype=f32, device=dev)
            for _ in range(ns_iters):
                x_ns = _ns_iter(x_ns, p_new, eye2)
            if ns_extra is not None:
                x_ns = ns_extra(x_ns, p_new, eye2, tau)
            v_new = 0.5 * (x_ns + x_ns.T)
            w_dyn_new = v_new @ g_vec
            ns_ok = torch.isfinite(torch.sum(v_new) + torch.sum(w_dyn_new))
            if ns_tau_max is not None:
                ns_ok = ns_ok & (tau < ns_tau_max)
            upd_ok = dyn_ok & ns_ok
            w_dyn_new = torch.where(upd_ok, w_dyn_new, carry.w_dyn)
            # cond-free segment (mega): a skipped V update MUST also skip P;
            # the per-step segment's exact fallback recomputes V from p_new,
            # so there P always advances
            p_keep = upd_ok if ns_tau_max is not None else dyn_ok
            new = new._replace(
                p_mat=torch.where(p_keep, p_new, carry.p_mat),
                v_mat=torch.where(upd_ok, v_new, carry.v_mat),
                w_dyn=w_dyn_new,
            )
            inf = torch.full((), float("inf"), dtype=f32, device=dev)
            tau = torch.where(dyn_ok, torch.where(ns_ok, tau, inf), zero)

        if feat is not None:
            resid = dx - mm(feat, w_dyn_new)
            if m_col is not None:
                mse_dyn = torch.sum(resid * resid * m_col) / (b * xd)
            else:
                mse_dyn = torch.mean(resid * resid)
        else:
            mse_dyn = _stats_mse(sums, w_dyn_new, b)
        dyn_n = torch.clamp(new.dyn_n[0, 0], max=float(cfg.state_var_cap))
        tot_d = dyn_n + count
        var_d = (dyn_n / tot_d) * torch.exp(slogvar) + (count / tot_d) * mse_dyn
        slv_new = torch.clamp(torch.log(var_d), -cfg.logvar_clamp, cfg.logvar_clamp)
        noise_ok = torch.isfinite(var_d)
        new = new._replace(
            state_logvar=torch.where(noise_ok, slv_new, slogvar).reshape(1, 1),
            dyn_n=torch.where(noise_ok, tot_d, new.dyn_n[0, 0]).reshape(1, 1),
        )

    scal = ScalarPack(
        loss=loss.reshape(1, 1),
        recon=(-l_recon).reshape(1, 1),
        dyn=(-l_dyn).reshape(1, 1),
        ent=h_ent.reshape(1, 1),
        tau=tau.reshape(1, 1),
    )
    return new, scal, g_vec


def step_math(
    cfg: VJFConfig,
    flags: StepFlags,
    carry: FusedCarry,
    qs_m: torch.Tensor,
    qs_lv: torch.Tensor,
    y: torch.Tensor,
    u: Optional[torch.Tensor],
    eps_s: torch.Tensor,
    eps_t: torch.Tensor,
    lr: torch.Tensor,
    ns_extra=None,
    ns_tau_max: Optional[float] = None,
    ns_iters: int = NS_ITERS,
    mask: Optional[torch.Tensor] = None,
    cmask: Optional[torch.Tensor] = None,
) -> StepOut:
    """The whole step on padded tensors: :func:`step_forward_sums` composed
    with :func:`step_apply`. ``ns_extra(x_ns, p_new, eye2, tau)`` optionally
    escalates Newton-Schulz; ``ns_tau_max`` gates the V/w update for
    segments without an exact-inverse fallback. Under the trial ``mask`` a
    masked row's posterior is frozen at ``(qs_m, qs_lv)``; the channel mask
    ``cmask`` freezes nothing (a row with every channel masked is a pure
    prediction step)."""
    b = y.shape[0]
    sums, per = step_forward_sums(
        cfg, flags, carry, qs_m, qs_lv, y, u, eps_s, eps_t, 1.0 / b, mask=mask, cmask=cmask,
    )
    new, scal, g_vec = step_apply(
        cfg, flags, carry, sums, lr, b, feat=per.feat, dx=per.dx,
        ns_extra=ns_extra, ns_tau_max=ns_tau_max, ns_iters=ns_iters, mask=mask,
    )
    qt_m, qt_lv = per.qt_m, per.qt_lv
    if mask is not None:
        keep = mask.reshape(-1, 1) > 0
        qt_m, qt_lv = torch.where(keep, qt_m, qs_m), torch.where(keep, qt_lv, qs_lv)
    return StepOut(
        carry=new, qt_mean=qt_m, qt_logvar=qt_lv, g_vec=g_vec,
        xt=per.xt, xs=per.xs, scal=scal,
    )


def _scal_row(s: ScalarPack) -> torch.Tensor:
    """(1, 8) row: loss, recon, dyn, ent, tau, then zeros."""
    z = torch.zeros((1, 3), dtype=s.loss.dtype, device=s.loss.device)
    return torch.cat([s.loss, s.recon, s.dyn, s.ent, s.tau, z], dim=1)


def _latents(carry: FusedCarry, b: int, xd: int, dtype, eps_s, eps_t, row0: int = 0):
    if eps_s is not None:
        return eps_s, eps_t
    return _rng.box_muller_latents(carry.rng_seed, carry.rng_count, b, xd, dtype, row0)


# ---------------------------------------------------------------------------
# Flat FusedSums layout: one buffer, so one all-reduce sums the whole tuple
# ---------------------------------------------------------------------------

# the array leaves in FusedSums order, each with the carry leaf of its shape;
# the flat buffer holds these, then _SUM_SCALARS (csrc/fused_step.cu:point_sums
# writes the same order)
_SUM_ARRAYS = (
    ("g_w_in_y", "w_in_y"), ("g_w_in_u", "w_in_u"), ("g_w_in_m", "w_in_m"),
    ("g_w_in_lv", "w_in_lv"), ("g_w_hidden", "w_hidden"), ("g_b_hidden", "b_hidden"),
    ("g_w_mean", "w_mean"), ("g_w_logvar", "w_logvar"), ("g_b_logvar", "b_logvar"),
    ("g_w_dec", "w_dec"), ("g_b_dec", "b_dec"), ("ftf_raw", "p_mat"), ("fxd_raw", "w_dyn"),
)
_SUM_SCALARS = ("g_lik_lv_batch", "recon_batch", "dyn_batch", "ent", "sq_y", "grad_check",
                "fvf_sum", "dx_sum", "dx2_sum")


def _array_leaves(tree, names):
    """The tensors of ``tree``'s fields ``names``, tuples flattened, None dropped."""
    out = []
    for n in names:
        v = getattr(tree, n)
        out.extend(v if isinstance(v, tuple) else () if v is None else (v,))
    return out


def _scalar_names(has_cm: bool) -> tuple:
    return _SUM_SCALARS + (("cm_sum",) if has_cm else ())


def sums_size(carry: FusedCarry, has_cm: bool = False) -> int:
    """Floats in the flat FusedSums buffer of ``carry``'s shapes; with
    ``has_cm`` (a channel mask) one more scalar, ``cm_sum``."""
    return sum(t.numel() for t in _array_leaves(carry, [c for _, c in _SUM_ARRAYS])) + len(
        _scalar_names(has_cm))


def pack_sums(sums: FusedSums) -> torch.Tensor:
    """FusedSums -> one contiguous 1-D buffer: the array leaves in field
    order, then the scalar leaves (``_SUM_SCALARS``, then ``cm_sum`` when
    it is given)."""
    arrays = _array_leaves(sums, [n for n, _ in _SUM_ARRAYS])
    scalars = torch.stack([getattr(sums, n).reshape(())
                           for n in _scalar_names(sums.cm_sum is not None)])
    return torch.cat([a.reshape(-1) for a in arrays] + [scalars])


def unpack_sums(flat: torch.Tensor, carry: FusedCarry, has_cm: bool = False) -> FusedSums:
    """Inverse of :func:`pack_sums`; each gradient leaf takes its parameter's
    shape from ``carry``. The leaves are views of ``flat``."""
    if flat.shape != (sums_size(carry, has_cm),):
        raise ValueError(f"flat sums of shape {tuple(flat.shape)}, the carry needs "
                         f"{sums_size(carry, has_cm)} floats")
    off = 0

    def take(like):
        nonlocal off
        v = flat[off:off + like.numel()].view(like.shape)
        off += like.numel()
        return v

    fields = {}
    for name, leaf in _SUM_ARRAYS:
        ref = getattr(carry, leaf)
        fields[name] = (tuple(take(r) for r in ref) if isinstance(ref, tuple)
                        else None if ref is None else take(ref))
    for name in _scalar_names(has_cm):
        fields[name] = flat[off]
        off += 1
    return FusedSums(**fields)


# ---------------------------------------------------------------------------
# Kernel wrappers: the per-step kernel and the mega (grid-over-time) kernel
# ---------------------------------------------------------------------------


class PackedStepOut(NamedTuple):
    carry: FusedCarry
    q_pack: torch.Tensor                  # (2, B, xd): qt mean / logvar
    g_vec: torch.Tensor
    xt: torch.Tensor
    xs: torch.Tensor
    scal: torch.Tensor                    # (1, 8): loss, recon, dyn, ent, tau


def stack_carries(carries) -> FusedCarry:
    """Member carries as one carry whose every leaf has a leading member
    axis: the layout of an ensemble launch."""
    def stack(*leaves):
        if leaves[0] is None:
            return None
        if isinstance(leaves[0], tuple):
            return tuple(torch.stack(x) for x in zip(*leaves))
        return torch.stack(leaves)

    return FusedCarry(*(stack(*f) for f in zip(*carries)))


def member_carry(carry: FusedCarry, m: int) -> FusedCarry:
    """Member ``m`` of a stacked carry, as views: an ensemble launch that
    updates the stack in place shows through."""
    def pick(v):
        if v is None:
            return None
        return tuple(x[m] for x in v) if isinstance(v, tuple) else v[m]

    return FusedCarry(*(pick(v) for v in carry))


def n_members(carry: FusedCarry) -> int:
    """N of a stacked carry (:func:`stack_carries`, an ensemble), 0 of a
    solo one."""
    return carry.p_mat.shape[0] if carry.p_mat.dim() == 3 else 0


def _over_members(fn, ndim: int, cfg, flags, carry, qs_m, qs_lv, ys, us, eps_s, eps_t, lr,
                  mask, cmask):
    """``fn``, a solo plain version, for each member of the stacked
    ``carry``, the results stacked. ``ys`` and ``us`` are stacked or, with
    the ``ndim`` dims of one member's, one copy for all; ``qs_*`` and
    ``eps_*`` are stacked; ``mask``, ``cmask`` and ``lr`` are one for all."""
    def own(x, m):
        return x if x is None or x.dim() == ndim else x[m]

    outs = [fn(cfg, flags, member_carry(carry, m), qs_m[m], qs_lv[m], own(ys, m), own(us, m),
               None if eps_s is None else eps_s[m], None if eps_t is None else eps_t[m], lr,
               mask=mask, cmask=cmask)
            for m in range(n_members(carry))]
    out = (stack_carries([o[0] for o in outs]),
           *(torch.stack(f) for f in list(zip(*outs))[1:]))
    return PackedStepOut(*out) if isinstance(outs[0], PackedStepOut) else out


def fused_step_plain(cfg, flags, carry, qs_m, qs_lv, y, u, eps_s, eps_t, lr, mask=None,
                     cmask=None) -> PackedStepOut:
    """Plain version of the per-step kernel: ``step_math`` with the fixed
    ``NS_ITERS`` and no tau ceiling, packed like the kernel's outputs.
    ``eps_s=None`` draws the noise from the carry's Philox stream; ``mask``
    (B,) and ``cmask`` (B, ydim) as in :func:`step_math`. A stacked carry:
    each member in turn, the operands as :func:`fused_step_call` takes
    them."""
    if n_members(carry):
        return _over_members(fused_step_plain, 2, cfg, flags, carry, qs_m, qs_lv, y, u, eps_s,
                             eps_t, lr, mask, cmask)
    eps_s, eps_t = _latents(carry, y.shape[0], cfg.xdim, y.dtype, eps_s, eps_t)
    out = step_math(cfg, flags, carry, qs_m, qs_lv, y, u, eps_s, eps_t, lr, mask=mask,
                    cmask=cmask)
    new = out.carry._replace(rng_count=carry.rng_count + 1)
    return PackedStepOut(new, torch.stack([out.qt_mean, out.qt_logvar]),
                         out.g_vec, out.xt, out.xs, _scal_row(out.scal))


def mega_ns_base_iters(cfg: VJFConfig, n_batch: int, masked: bool = False) -> int:
    """Batch-adaptive base Newton-Schulz iterations of the mega segment: 1
    at 64 trials or more, else 2. Under a trial mask (``masked``) 2, since
    the padded batch says nothing of a step's valid count."""
    return int(cfg.mega_ns_iters) or (
        1 if n_batch >= NS_ONE_ITER_MIN_BATCH and not masked else 2)


def _ns_escalate(x_ns, p_new, eye2, tau):
    """+1 iteration at tau >= NS_TAU_ESCALATE, +NS_EXTRA_ITERS more at
    tau >= NS_TAU_THRESHOLD: computed and selected, with no host sync."""
    x1 = _ns_iter(x_ns, p_new, eye2)
    x_ns = torch.where(tau >= NS_TAU_ESCALATE, x1, x_ns)
    x2 = x_ns
    for _ in range(NS_EXTRA_ITERS):
        x2 = _ns_iter(x2, p_new, eye2)
    return torch.where(tau >= NS_TAU_THRESHOLD, x2, x_ns)


def mega_epoch_plain(cfg, flags, carry, qs_m, qs_lv, ys, us, eps_s, eps_t, lr, mask=None,
                     cmask=None):
    """Plain version of the mega kernel: a loop over the T steps of ``ys``
    with the base iterations, the escalation and the ``NS_TAU_MAX`` skip;
    ``mask`` (T, B) and ``cmask`` (T, B, ydim) by step. Returns ``(carry,
    q_pack (T, 2, B, xd), scal (T, 8))``. A stacked carry: each member in
    turn, the operands as :func:`mega_epoch_call` takes them, the results
    with a leading member axis."""
    if n_members(carry):
        return _over_members(mega_epoch_plain, 3, cfg, flags, carry, qs_m, qs_lv, ys, us,
                             eps_s, eps_t, lr, mask, cmask)
    t_total, b, _ = ys.shape
    base = mega_ns_base_iters(cfg, b, masked=mask is not None)
    qm, qlv = qs_m, qs_lv
    qs, scals = [], []
    for t in range(t_total):
        e_s, e_t = _latents(carry, b, cfg.xdim, ys.dtype,
                            None if eps_s is None else eps_s[t],
                            None if eps_t is None else eps_t[t])
        out = step_math(cfg, flags, carry, qm, qlv, ys[t],
                        us[t] if us is not None else None, e_s, e_t, lr,
                        ns_extra=_ns_escalate, ns_tau_max=NS_TAU_MAX, ns_iters=base,
                        mask=None if mask is None else mask[t],
                        cmask=None if cmask is None else cmask[t])
        carry = out.carry._replace(rng_count=carry.rng_count + 1)
        qm, qlv = out.qt_mean, out.qt_logvar
        qs.append(torch.stack([qm, qlv]))
        scals.append(_scal_row(out.scal))
    return carry, torch.stack(qs), torch.cat(scals, dim=0)


def forward_sums_plain(cfg, flags, carry, qs_m, qs_lv, y, u, eps_s, eps_t, inv_b,
                       row0: int = 0, mask=None, cmask=None):
    """Plain version of the phase-1 kernel: :func:`step_forward_sums` on this
    rank's trials with the GLOBAL ``inv_b`` (under a trial mask, ``1 /
    max(global valid count, 1)``). Returns ``(flat sums, q_pack (2,
    B_local, xd))``, the posterior not frozen; the carry is left as it is.
    ``eps_s=None`` draws rows ``[row0, row0 + B_local)`` of the whole
    batch's Philox draw. ``mask`` (B_local,) and ``cmask`` (B_local, ydim)
    are this rank's rows; a channel mask adds ``cm_sum`` to the buffer."""
    eps_s, eps_t = _latents(carry, y.shape[0], cfg.xdim, y.dtype, eps_s, eps_t, row0)
    sums, per = step_forward_sums(cfg, flags, carry, qs_m, qs_lv, y, u, eps_s, eps_t, inv_b,
                                  mask=mask, cmask=cmask, local_renorm=False)
    return pack_sums(sums), torch.stack([per.qt_m, per.qt_lv])


# ---------------------------------------------------------------------------
# ctypes binding of csrc/fused_step.cu
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p


def cluster_size() -> int:
    """Blocks in the kernels' thread-block cluster (``VJF_CLUSTER`` of
    ``csrc/fused_step.cu``, a compile-time constant of the build)."""
    from . import _build

    return _build.CLUSTER


def cluster_rows(rank: int, total: int, size: Optional[int] = None) -> range:
    """The contiguous rows block ``rank`` of the cluster owns out of
    ``total`` (trials, or rows of P, V and w): ``ceil(total / size)`` each,
    the last blocks fewer or none. Mirrors ``block_of`` in
    ``csrc/fused_step.cu``."""
    size = cluster_size() if size is None else size
    per = -(-total // size)
    first = min(rank * per, total)
    return range(first, first + min(per, total - first))


class _Args(ctypes.Structure):
    """Mirror of ``struct VJFArgs`` in ``csrc/fused_step.cu``."""

    _fields_ = (
        [(n, _P) for n in ("w_in_y", "w_in_u", "w_in_m", "w_in_lv", "layers")]
        + [("widths", ctypes.POINTER(ctypes.c_int))]
        + [(n, _P) for n in (
            "w_mean", "w_logvar", "b_logvar", "w_dec", "b_dec", "cent_x", "cent_u",
            "c2", "inv_w2", "w_white", "scale2", "p_mat", "v_mat", "w_dyn", "state_logvar",
            "lik_logvar", "dyn_n", "lik_n", "rng_seed", "rng_count", "qs_m", "qs_lv", "y", "u",
            "eps_s", "eps_t", "mask", "cmask", "lr", "q_pack", "scal", "g_vec", "xt", "xs",
            "sums", "ws")]
        + [(n, ctypes.c_int) for n in ("T", "B", "yd", "ud", "xd", "nfp", "nf", "n_layers")]
        + [(n, ctypes.c_int) for n in ("tile", "kc", "sp")]
        + [(n, ctypes.c_int) for n in (
            "sgd", "update", "warm_up", "train_decoder", "update_likelihood",
            "update_transition", "poisson", "trace_quirk", "bf16", "mega", "ns_iters",
            "row0", "n_members", "shared")]
        + [(n, ctypes.c_float) for n in (
            "leak", "poisson_clamp", "logvar_clamp", "clip", "rls_shrink",
            "chol_jitter", "obs_var_cap", "state_var_cap", "inv_b")]
    )


# Bits of ``VJFArgs.shared``: data of an ensemble launch that every member
# reads from one copy (``SHARED_*`` in ``csrc/fused_step.cu``).
_SHARED = {"y": 1, "u": 2}


def _library():
    from . import _build

    lib = _build.load_library()
    if not getattr(lib, "_vjf_bound", False):
        for name in ("vjf_fused_step", "vjf_mega_epoch", "vjf_forward_sums"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.POINTER(_Args), _P]
            fn.restype = ctypes.c_int
        for name in ("vjf_workspace_floats", "vjf_sums_floats", "vjf_smem_bytes"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.POINTER(_Args)]
            fn.restype = ctypes.c_size_t
        for name in ("vjf_args_size", "vjf_args_tail", "vjf_layer_arg_size", "vjf_smem_limit"):
            fn = getattr(lib, name)
            fn.argtypes = []
            fn.restype = ctypes.c_size_t
        lib.vjf_cluster_info.argtypes = [ctypes.POINTER(_Args), ctypes.POINTER(ctypes.c_int)]
        lib.vjf_cluster_info.restype = ctypes.c_int
        lib.vjf_philox_normals.argtypes = [ctypes.c_int] * 4 + [_P] * 4
        lib.vjf_philox_normals.restype = ctypes.c_int
        if (lib.vjf_args_size(), lib.vjf_args_tail()) != (ctypes.sizeof(_Args), _Args.inv_b.offset):
            raise RuntimeError("VJFArgs layout differs between fused_step.cu and _Args")
        if lib.vjf_layer_arg_size() != 8 * _LAYER_WORDS:
            raise RuntimeError("LayerArg differs between fused_step.cu and _layer_table")
        lib._vjf_bound = True
    return lib


def _dims(cfg: VJFConfig, n_batch: int, t_total: int = 1, mask: bool = False,
          cmask: bool = False) -> _Args:
    """An ``_Args`` with the dimensions of ``cfg`` at ``n_batch`` trials and
    no operands: enough for the library's size queries. ``mask`` and
    ``cmask`` set those two pointers to a non-null placeholder, since a
    block stages them (the queries read no operand)."""
    a = _Args()
    a.mask, a.cmask = (1 if mask else None), (1 if cmask else None)
    a.T, a.B, a.yd, a.ud, a.xd = t_total, n_batch, cfg.ydim, cfg.udim, cfg.xdim
    a.nfp, a.nf = _round_up(cfg.feature_dim), cfg.feature_dim
    a.n_layers = len(cfg.hidden_sizes)
    a.widths = (ctypes.c_int * a.n_layers)(*cfg.hidden_sizes)   # kept alive by ``a``
    return a


def kernel_limits(cfg: VJFConfig, n_batch: int, on_card: bool = True, mask: bool = False,
                  channel_mask: bool = False) -> Optional[str]:
    """The first limit of the kernels that ``cfg`` at ``n_batch`` trials
    exceeds, as a message, or None: with ``on_card`` a block's shared memory
    within the card's at the kernels' tile plan (``vjf_smem_bytes`` against
    ``vjf_smem_limit``, which builds the library; at the smallest trial tile,
    chunk and sub-panel of the L2 route where no plan fits), counting the
    staging of a trial ``mask`` and of a ``channel_mask`` and every hidden
    layer's activations. Only an input or a hidden layer far wider than any
    configuration of the repository, or hundreds of hidden layers, are
    refused: any number of trials, and padded features up to 1,792 at the
    flagship widths, are taken. The recognition network has at least one
    hidden layer (its first takes the inputs).
    :func:`_launch` raises on it, and :func:`fused_enabled` routes away from
    it under ``fused_step='auto'``. The number of members of an ensemble
    launch has no limit: a member is one cluster, and those past what the
    card holds at once (:func:`cluster_info`'s ``active_clusters``) run in a
    later wave."""
    if not cfg.hidden_sizes:
        return "no hidden layer: the kernels' first layer takes the inputs"
    if on_card:
        lib = _library()
        dims = _dims(cfg, n_batch, mask=mask, cmask=channel_mask)
        need, limit = lib.vjf_smem_bytes(ctypes.byref(dims)), lib.vjf_smem_limit()
        if need > limit:
            what = " with a channel mask" if channel_mask else ""
            return (f"{n_batch} trials over {cluster_size()} blocks at these widths{what} need "
                    f"{need} bytes of shared memory a block at the smallest trial tile and "
                    f"sub-panel, over "
                    f"the card's {limit}")
    return None


def _ptr(t: Optional[torch.Tensor], name: str, shape=None, dtype=torch.float32,
         device=None) -> Optional[int]:
    """Checked device pointer of a tensor the kernel reads or writes."""
    if t is None:
        return None
    if t.device.type != "cuda" or (device is not None and t.device != device):
        raise ValueError(f"{name}: expected a tensor on {device}, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the kernel takes contiguous tensors")
    return t.data_ptr()


_LAUNCHERS = {"fused_step": "vjf_fused_step", "mega_epoch": "vjf_mega_epoch",
              "forward_sums": "vjf_forward_sums"}
_LAUNCH_SPANS = {k: f"vjf.launch.{k}" for k in _LAUNCHERS}

# ``LayerArg`` of csrc/fused_step.cu: weights pointer (0 for the first layer),
# bias pointer, width, one int64 each
_LAYER_WORDS = 3
_TABLES: "collections.OrderedDict[tuple, torch.Tensor]" = collections.OrderedDict()
_TABLES_KEPT = 64


def _layer_table(layers, device) -> torch.Tensor:
    """The kernels' table of hidden layers, ``(n_layers, 3)`` int64 on
    ``device``: each layer's weights and bias pointers and its width (every
    block copies it into its shared memory). The kernels update the carry in
    place, so its pointers stay the same from launch to launch: the table is
    copied to the card once for each content and kept (the last
    ``_TABLES_KEPT``), not once a launch."""
    key = (str(device), tuple(layers))
    table = _TABLES.get(key)
    if table is None:
        table = torch.tensor(layers, dtype=torch.int64).to(device)
        _TABLES[key] = table
        while len(_TABLES) > _TABLES_KEPT:
            _TABLES.popitem(last=False)
    else:
        _TABLES.move_to_end(key)
    return table


def _launch(kernel: str, cfg, flags, carry: FusedCarry, qs_m, qs_lv, ys, us, eps_s,
            eps_t, lr, q_pack, scal, g_vec=None, xt=None, xs=None, ns_iters=0,
            sums=None, inv_b=0.0, row0=0, mask=None, cmask=None):
    """Check every operand and launch ``vjf_fused_step``, ``vjf_mega_epoch``
    or ``vjf_forward_sums`` on the current stream, or, with
    ``kernel="info"``, launch nothing and return :func:`cluster_info`'s
    numbers. ``ys``/``us``/``eps_*`` carry a leading time axis; ``ns_iters``
    is the mega kernel's base Newton-Schulz iterations (each launcher sets
    its own mode). The phase-1 kernel takes ``sums`` (the flat buffer),
    ``inv_b`` and ``row0`` (the first row of this rank's trials in the whole
    batch) and no ``lr`` or ``scal``. ``mask`` (T, B) and ``cmask`` (T, B,
    ydim) are the 0/1 masks by step, or None. Raises ``ValueError`` for a
    tensor that does not lie on the card and for a shape the kernel does
    not take: nothing falls back to the plain version. The limits are those
    of :func:`kernel_limits`.

    A stacked carry (:func:`stack_carries`) is an ensemble launch of N
    members, N clusters. Every carry leaf, output, ``qs_m``/``qs_lv`` and
    ``eps_*`` then has a leading member axis; ``ys`` and ``us`` have one
    too, or are given without it as one copy that every member reads
    (stride 0); ``mask``, ``cmask`` and ``lr`` are one for all.

    A launch, from the operands' checks through the library's call, is the
    span ``vjf.launch.<kernel>`` (:mod:`.trace`)."""
    with _trace.NULL if kernel == "info" else _trace.span(_LAUNCH_SPANS[kernel]):
        dev = carry.p_mat.device
        t_total, b, yd = ys.shape[-3:]
        reason = kernel_limits(cfg, b, on_card=False)
        if reason is not None:
            raise ValueError(f"the kernels do not take this configuration: {reason}")
        xd, nfp = cfg.xdim, _round_up(cfg.feature_dim)
        ud = 0 if us is None else us.shape[-1]
        n_mem = n_members(carry)
        lead = (n_mem,) if n_mem else ()
        widths = list(cfg.hidden_sizes)
        if len(carry.b_hidden) != len(widths):
            raise ValueError(f"a carry of {len(carry.b_hidden)} hidden layers, cfg has {widths}")
        sgp = cfg.dynamics == "sgp"
        if (carry.w_white is not None, carry.scale2 is not None) != (sgp, sgp):
            raise ValueError(f"dynamics={cfg.dynamics!r}: w_white and scale2 are given "
                             "exactly for SGP")
        if (ud > 0) != (carry.w_in_u is not None) or ud != cfg.udim:
            raise ValueError(f"controls of width {ud} do not match udim={cfg.udim}")
        if (eps_s is None) != (eps_t is None):
            raise ValueError("eps_s and eps_t are given together or not at all")
        h0, hl = widths[0], widths[-1]

        def c(t, name, shape, dtype=torch.float32):
            return _ptr(t, name, lead + tuple(shape), dtype, dev)

        a = _dims(cfg, b, t_total)
        a.n_members = n_mem

        def d(t, name, shape):
            """Data: per member, or in an ensemble launch one copy for all."""
            if n_mem and t is not None and t.dim() == len(shape):
                a.shared |= _SHARED[name]
                return _ptr(t, name, shape, device=dev)
            return c(t, name, shape)
        a.w_in_y = c(carry.w_in_y, "w_in_y", (h0, yd))
        a.w_in_u = c(carry.w_in_u, "w_in_u", (h0, ud))
        a.w_in_m = c(carry.w_in_m, "w_in_m", (h0, xd))
        a.w_in_lv = c(carry.w_in_lv, "w_in_lv", (h0, xd))
        layers = [(0 if i == 0 else c(carry.w_hidden[i - 1], f"w_hidden[{i - 1}]",
                                      (wd, widths[i - 1])),
                   c(carry.b_hidden[i], f"b_hidden[{i}]", (1, wd)), wd)
                  for i, wd in enumerate(widths)]
        a.w_mean = c(carry.w_mean, "w_mean", (xd, hl))
        a.w_logvar = c(carry.w_logvar, "w_logvar", (xd, hl))
        a.b_logvar = c(carry.b_logvar, "b_logvar", (1, xd))
        a.w_dec = c(carry.w_dec, "w_dec", (yd, xd))
        a.b_dec = c(carry.b_dec, "b_dec", (1, yd))
        a.cent_x = c(carry.cent_x, "cent_x", (nfp, xd))
        a.cent_u = c(carry.cent_u, "cent_u", (nfp, ud))
        a.c2 = c(carry.c2, "c2", (1, nfp))
        a.inv_w2 = c(carry.inv_w2, "inv_w2", (1, nfp))
        a.w_white = c(carry.w_white, "w_white", (nfp, nfp))
        a.scale2 = c(carry.scale2, "scale2", (1, 1))
        a.p_mat = c(carry.p_mat, "p_mat", (nfp, nfp))
        a.v_mat = c(carry.v_mat, "v_mat", (nfp, nfp))
        a.w_dyn = c(carry.w_dyn, "w_dyn", (nfp, xd))
        for n in ("state_logvar", "lik_logvar", "dyn_n", "lik_n"):
            setattr(a, n, c(getattr(carry, n), n, (1, 1)))
        a.rng_seed = c(carry.rng_seed, "rng_seed", (1, 1), torch.int32)
        a.rng_count = c(carry.rng_count, "rng_count", (1, 1), torch.int32)
        a.qs_m = c(qs_m, "qs_m", (b, xd))
        a.qs_lv = c(qs_lv, "qs_lv", (b, xd))
        a.y = d(ys, "y", (t_total, b, yd))
        a.u = d(us, "u", (t_total, b, ud))
        a.eps_s = c(eps_s, "eps_s", (t_total, b, xd))
        a.eps_t = c(eps_t, "eps_t", (t_total, b, xd))
        a.mask = _ptr(mask, "mask", (t_total, b), device=dev)
        a.cmask = _ptr(cmask, "cmask", (t_total, b, yd), device=dev)
        a.lr = _ptr(lr, "lr", (), torch.float32, dev)
        a.q_pack = c(q_pack, "q_pack", (t_total, 2, b, xd) if q_pack.dim() == 4 + len(lead)
                     else (2, b, xd))
        a.scal = c(scal, "scal", (t_total, 8))
        a.row0, a.inv_b = int(row0), float(inv_b)
        a.g_vec = c(g_vec, "g_vec", (nfp, xd))
        a.xt = c(xt, "xt", (b, xd))
        a.xs = c(xs, "xs", (b, xd))
        a.sgd, a.update, a.warm_up = int(flags.sgd), int(flags.update), int(flags.warm_up)
        a.train_decoder = int(flags.train_decoder)
        a.update_likelihood = int(flags.update_likelihood)
        a.update_transition = int(flags.update_transition)
        a.poisson = int(cfg.likelihood == "poisson")
        a.trace_quirk = int(cfg.trace_quirk)
        a.bf16 = int(cfg.matmul_dtype == "bfloat16")
        a.ns_iters = int(ns_iters)
        a.leak, a.poisson_clamp, a.logvar_clamp = cfg.leak, cfg.poisson_clamp, cfg.logvar_clamp
        a.clip, a.rls_shrink, a.chol_jitter = cfg.clip, cfg.rls_shrink, cfg.chol_jitter
        a.obs_var_cap, a.state_var_cap = float(cfg.obs_var_cap), float(cfg.state_var_cap)

        lib = _library()
        reason = kernel_limits(cfg, b, mask=mask is not None, channel_mask=cmask is not None)
        if reason is not None:
            raise ValueError(f"the kernels do not take this configuration: {reason}")
        if kernel == "info":
            out = (ctypes.c_int * 9)()
            rc = lib.vjf_cluster_info(ctypes.byref(a), out)
            if rc != 0:
                raise RuntimeError(f"vjf_cluster_info failed: cudaError {rc}")
            return dict(zip(("cluster", "threads", "smem_bytes", "active_clusters", "registers",
                             "local_bytes", "tile_rows", "stage_rows", "sub_rows"), out))
        if sums is not None:
            a.sums = c(sums, "sums", (lib.vjf_sums_floats(ctypes.byref(a)),))
        ws = torch.empty(max(n_mem, 1) * lib.vjf_workspace_floats(ctypes.byref(a)),
                         dtype=torch.float32, device=dev)
        a.ws = ws.data_ptr()
        a.layers = _layer_table(layers, dev).data_ptr()
        fn = getattr(lib, _LAUNCHERS[kernel])
        with torch.cuda.device(dev):
            rc = fn(ctypes.byref(a), torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{kernel} kernel launch failed: cudaError {rc}")


def cluster_info(cfg, flags, carry: FusedCarry, qs_m, qs_lv, ys, us, lr, mask=None,
                 cmask=None) -> dict:
    """How the fused kernel would launch on these operands, without
    launching it: blocks in the cluster, threads a block, bytes of dynamic
    shared memory a block, clusters the card holds at once, registers a
    thread, bytes of local memory a thread (register spills), and the tile
    plan of ``plan_tiles`` in csrc/fused_step.cu (trials a phase-1 tile,
    rows a staged chunk, rows a staged sub-panel: 0 where the panels and the
    trials' state are resident), with the staging of ``mask`` and ``cmask`` where
    given. With a stacked carry (see :func:`_launch`) also the members and
    the waves their clusters run in: a member is one cluster, and the card
    holds ``active_clusters`` of them at once."""
    t_total, b, _ = ys.shape[-3:]
    n = n_members(carry)
    lead = carry.p_mat.shape[:-2]
    q_pack = torch.empty(lead + (t_total, 2, b, cfg.xdim), dtype=ys.dtype, device=ys.device)
    scal = torch.empty(lead + (t_total, 8), dtype=ys.dtype, device=ys.device)
    info = _launch("info", cfg, flags, carry, qs_m, qs_lv, ys, us, None, None, lr, q_pack,
                   scal, mask=mask, cmask=cmask)
    if n:
        info["members"] = n
        info["member_waves"] = -(-n // max(info["active_clusters"], 1))
    return info


def philox_normals_kernel(seed: int, count: int, rows: int, cols: int, device):
    """The in-kernel sampler alone (``philox_pair`` + Box-Muller of
    ``csrc/fused_step.cu``): ``(u1, u2, eps)``, each ``(rows, cols)`` f32 on
    ``device``, for comparison with :mod:`.rng`."""
    if (rows * cols) % 2:
        raise ValueError("rows * cols must be even")
    out = [torch.empty((rows, cols), dtype=torch.float32, device=device) for _ in range(3)]
    rc = _library().vjf_philox_normals(
        int(seed), int(count), rows, cols, *(t.data_ptr() for t in out),
        torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"philox kernel launch failed: cudaError {rc}")
    return tuple(out)


def _on_cuda(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def _kernel_mask(m: Optional[torch.Tensor], shape=None) -> Optional[torch.Tensor]:
    """A mask as the kernels read it: f32, contiguous, ``shape`` (its own by
    default; no copy when it is one already). The kernels and the plain
    versions read an entry as valid where it is > 0."""
    if m is None:
        return None
    return m.to(torch.float32).reshape(m.shape if shape is None else shape).contiguous()


def _count(kernel: str, carry: FusedCarry, t_total: int) -> None:
    """One launch of ``kernel`` on ``carry``, under ``<kernel>.ensemble``
    when the carry is stacked (its steps then member-steps)."""
    n = n_members(carry)
    key = f"{kernel}.ensemble" if n else kernel
    launches[key] += 1
    steps[key] += max(n, 1) * t_total


def _one_step(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """A step's (B, d) operand, stacked or not, with the time axis of length
    1 that a launch reads."""
    return None if x is None else x.unsqueeze(-3)


def fused_step_call(cfg, flags, carry, qs_m, qs_lv, y, u, eps_s, eps_t, lr, mask=None,
                    cmask=None) -> PackedStepOut:
    """One fused step. On CUDA tensors: the ``fused_step`` kernel, which
    updates the carry IN PLACE (the returned carry holds the same tensors);
    on CPU tensors: :func:`fused_step_plain`. ``eps_s=None`` selects the
    in-kernel Philox noise; ``mask`` (B,) or (B, 1) and ``cmask`` (B, ydim)
    as in :func:`step_math`.

    A stacked carry (:func:`stack_carries`) steps N members in ONE launch
    of N clusters, the counterpart of the JAX package's ``vmap`` over
    members: ``qs_*`` and ``eps_*`` are then stacked, ``y`` and ``u``
    stacked (N, B, ...) or one copy for all, ``mask``, ``cmask`` and ``lr``
    one for all, and every output has a leading member axis."""
    if not _on_cuda(carry.p_mat):
        return fused_step_plain(cfg, flags, carry, qs_m, qs_lv, y, u, eps_s, eps_t, lr,
                                mask=mask, cmask=cmask)
    lead = carry.p_mat.shape[:-2]
    b, xd, nfp = y.shape[-2], cfg.xdim, carry.p_mat.shape[-1]
    dev, dt = y.device, y.dtype
    q_pack = torch.empty(lead + (2, b, xd), dtype=dt, device=dev)
    g_vec = torch.empty(lead + (nfp, xd), dtype=dt, device=dev)
    xt = torch.empty(lead + (b, xd), dtype=dt, device=dev)
    xs = torch.empty(lead + (b, xd), dtype=dt, device=dev)
    scal = torch.empty(lead + (1, 8), dtype=dt, device=dev)
    _launch(
        "fused_step", cfg, flags, carry, qs_m, qs_lv, _one_step(y), _one_step(u),
        _one_step(eps_s), _one_step(eps_t), lr, q_pack, scal, g_vec=g_vec, xt=xt, xs=xs,
        mask=_kernel_mask(mask, (1, b)), cmask=_kernel_mask(cmask, (1, b, y.shape[-1])),
    )
    _count("fused_step", carry, 1)
    return PackedStepOut(carry, q_pack, g_vec, xt, xs, scal)


def mega_epoch_call(cfg, flags, carry, qs_m, qs_lv, ys, us, eps_s, eps_t, lr, mask=None,
                    cmask=None):
    """``T = ys.shape[-3]`` fused steps. On CUDA tensors: ONE launch of the
    ``mega_epoch`` kernel, which loops over time and updates the carry IN
    PLACE; on CPU tensors: :func:`mega_epoch_plain`. ``eps_s=None`` selects
    the in-kernel Philox noise, continuing the carried ``rng_count``;
    ``mask`` (T, B) and ``cmask`` (T, B, ydim) by step. Returns ``(carry,
    q_pack (T, 2, B, xd), scal (T, 8))``. A stacked carry runs N members in
    one launch, the operands and outputs as in :func:`fused_step_call`."""
    if not _on_cuda(carry.p_mat):
        return mega_epoch_plain(cfg, flags, carry, qs_m, qs_lv, ys, us, eps_s, eps_t, lr,
                                mask=mask, cmask=cmask)
    lead = carry.p_mat.shape[:-2]
    t_total, b, yd = ys.shape[-3:]
    dev, dt = ys.device, ys.dtype
    q_pack = torch.empty(lead + (t_total, 2, b, cfg.xdim), dtype=dt, device=dev)
    scal = torch.empty(lead + (t_total, 8), dtype=dt, device=dev)
    _launch(
        "mega_epoch", cfg, flags, carry, qs_m, qs_lv, ys, us, eps_s, eps_t, lr,
        q_pack, scal, ns_iters=mega_ns_base_iters(cfg, b, masked=mask is not None),
        mask=_kernel_mask(mask, (t_total, b)), cmask=_kernel_mask(cmask, (t_total, b, yd)),
    )
    _count("mega_epoch", carry, t_total)
    return carry, q_pack, scal


def forward_sums_call(cfg, flags, carry, qs_m, qs_lv, y, u, eps_s, eps_t, inv_b,
                      row0: int = 0, mask=None, cmask=None):
    """Phase 1 of the sharded step on this rank's ``B_local`` trials, with
    the GLOBAL ``inv_b``: ``(flat sums, q_pack (2, B_local, xd))``, ready for
    one all-reduce of the flat buffer. On CUDA tensors: the ``forward_sums``
    kernel, which writes both outputs and updates NO carry leaf; on CPU
    tensors: :func:`forward_sums_plain`. ``eps_s=None`` selects the
    in-kernel Philox noise at row offset ``row0``. ``mask`` and ``cmask``:
    this rank's rows, with ``inv_b`` from the global valid count (see
    :func:`forward_sums_plain`)."""
    if not _on_cuda(carry.p_mat):
        return forward_sums_plain(cfg, flags, carry, qs_m, qs_lv, y, u, eps_s, eps_t,
                                  inv_b, row0, mask=mask, cmask=cmask)
    dev, dt = y.device, y.dtype
    b = y.shape[0]
    flat = torch.empty(sums_size(carry, has_cm=cmask is not None), dtype=dt, device=dev)
    q_pack = torch.empty((2, y.shape[0], cfg.xdim), dtype=dt, device=dev)
    _launch(
        "forward_sums", cfg, flags, carry, qs_m, qs_lv, y[None],
        None if u is None else u[None], None if eps_s is None else eps_s[None],
        None if eps_t is None else eps_t[None], None, q_pack, None,
        sums=flat, inv_b=inv_b, row0=row0,
        mask=_kernel_mask(mask, (1, b)), cmask=_kernel_mask(cmask, (1,) + tuple(y.shape)),
    )
    launches["forward_sums"] += 1
    steps["forward_sums"] += 1
    return flat, q_pack


# ---------------------------------------------------------------------------
# Padding between TrainState and FusedCarry
# ---------------------------------------------------------------------------


def pad_carry(cfg: VJFConfig, state) -> FusedCarry:
    """TrainState -> FusedCarry, padded once per epoch: centroids +1e6
    (padded basis responses underflow to exact 0), P/V identity pad block,
    dynamics weights zero pad. With SGP the inducing points are the
    centroids, ``inv_w2`` the uniform ``exp(-2 log_lengthscale)``,
    ``w_white = scale^2 W`` zero-padded and ``scale2`` (1, 1). Every leaf is
    a fresh contiguous tensor."""
    from ..models.regression import NSVBLR

    p = state.params
    blr = state.dynamics.blr
    if not isinstance(blr, NSVBLR):
        raise ValueError("the fused step requires the nsv backend")
    nf = blr.w_mean.shape[0]
    nfp = _round_up(nf)
    dtype, dev = blr.w_mean.dtype, blr.w_mean.device
    xd, ud, yd = cfg.xdim, cfg.udim, cfg.ydim

    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    d = state.dynamics
    cent_full = torch.full((nfp, xd + ud), 1e6, dtype=dtype, device=dev)
    w_white = scale2 = None
    if cfg.dynamics == "sgp":
        cent_full[:nf] = d.inducing
        # a uniform lengthscale; the pad columns still underflow to exact 0
        inv_w2 = torch.exp(-2.0 * d.log_lengthscale).expand(1, nfp).to(dtype).contiguous()
        scale2 = torch.exp(2.0 * d.log_scale).to(dtype).reshape(1, 1)
        w_white = z(nfp, nfp)
        w_white[:nf, :nf] = scale2 * d.whiten
    else:
        cent_full[:nf] = d.rbf.centroid
        inv_w2 = torch.ones((1, nfp), dtype=dtype, device=dev)
        inv_w2[0, :nf] = torch.exp(-2.0 * d.rbf.logwidth)
    c2 = torch.sum(cent_full * cent_full, dim=-1).reshape(1, nfp)

    pad_eye = torch.eye(nfp, dtype=dtype, device=dev)
    pad_eye[:nf, :nf] = 0.0
    p_mat = z(nfp, nfp)
    p_mat[:nf, :nf] = blr.precision
    v_mat = z(nfp, nfp)
    v_mat[:nf, :nf] = blr.cov
    w_dyn = z(nfp, xd)
    w_dyn[:nf] = blr.w_mean

    rec = p.recognition
    w0 = rec.layers[0].weight.detach()      # (h0, yd + ud + 2 xd)
    lik_lv = p.likelihood.logvar if cfg.likelihood == "gaussian" else z()

    def leaf(t):
        return t.detach().to(dtype).clone().contiguous()

    return FusedCarry(
        w_in_y=leaf(w0[:, :yd]),
        w_in_u=leaf(w0[:, yd:yd + ud]) if ud > 0 else None,
        w_in_m=leaf(w0[:, yd + ud:yd + ud + xd]),
        w_in_lv=leaf(w0[:, yd + ud + xd:]),
        w_hidden=tuple(leaf(layer.weight) for layer in rec.layers[1:]),
        b_hidden=tuple(leaf(layer.bias.reshape(1, -1)) for layer in rec.layers),
        w_mean=leaf(rec.mean.weight),
        w_logvar=leaf(rec.logvar.weight),
        b_logvar=leaf(rec.logvar.bias.reshape(1, -1)),
        w_dec=leaf(p.decoder.weight),
        b_dec=leaf(p.decoder.bias.reshape(1, -1)),
        cent_x=leaf(cent_full[:, :xd]),
        cent_u=leaf(cent_full[:, xd:]) if ud > 0 else None,
        c2=c2,
        inv_w2=inv_w2,
        w_white=w_white,
        scale2=scale2,
        p_mat=p_mat + pad_eye,
        v_mat=v_mat + pad_eye,
        w_dyn=w_dyn,
        state_logvar=leaf(state.dynamics.logvar.reshape(1, 1)),
        lik_logvar=leaf(lik_lv.reshape(1, 1)),
        dyn_n=leaf(state.dynamics.n_sample.reshape(1, 1)),
        lik_n=leaf(state.lik_n_sample.reshape(1, 1)),
        rng_seed=torch.zeros((1, 1), dtype=torch.int32, device=dev),
        rng_count=torch.zeros((1, 1), dtype=torch.int32, device=dev),
    )


def unpad_carry(cfg: VJFConfig, carry: FusedCarry, state_template):
    """FusedCarry -> TrainState (slice off padding, restore counters). The
    SGP's inducing points, hyperparameters and whitener only move between
    epochs: they come from ``state_template``."""
    from ..models.dynamics import DynamicsState
    from ..models.likelihoods import GaussianLikParams
    from ..models.rbf import RBFParams
    from ..models.recognition import Recognition, linear_from
    from ..models.regression import NSVBLR
    from ..models.vjf import Params, TrainState

    nf = state_template.dynamics.blr.w_mean.shape[0]
    tmpl_p = state_template.params
    segs = [carry.w_in_y] + ([carry.w_in_u] if carry.w_in_u is not None else []) + [
        carry.w_in_m, carry.w_in_lv
    ]
    w0 = torch.cat(segs, dim=1)
    layers = [linear_from(w0, carry.b_hidden[0].reshape(-1))] + [
        linear_from(w, b.reshape(-1))
        for w, b in zip(carry.w_hidden, carry.b_hidden[1:])
    ]
    rec = Recognition(
        layers,
        mean=linear_from(carry.w_mean),
        logvar=linear_from(carry.w_logvar, carry.b_logvar.reshape(-1)),
    )
    if cfg.likelihood == "gaussian":
        lik = GaussianLikParams(logvar=carry.lik_logvar.reshape(()))
    else:
        lik = tmpl_p.likelihood
    params = Params(
        recognition=rec,
        decoder=linear_from(carry.w_dec, carry.b_dec.reshape(-1)),
        likelihood=lik,
        prior=tmpl_p.prior,
    )
    blr_new = NSVBLR(
        w_mean=carry.w_dyn[:nf].clone(),
        precision=carry.p_mat[:nf, :nf].clone(),
        cov=carry.v_mat[:nf, :nf].clone(),
    )
    noise = dict(logvar=carry.state_logvar.reshape(()),
                 n_sample=carry.dyn_n.reshape(()).to(torch.int32))
    if cfg.dynamics == "sgp":
        dynamics = state_template.dynamics._replace(blr=blr_new, **noise)
    else:
        cent_segs = [carry.cent_x] + ([carry.cent_u] if carry.cent_u is not None else [])
        centroid = torch.cat(cent_segs, dim=1)[:nf]
        dynamics = DynamicsState(
            rbf=RBFParams(centroid, state_template.dynamics.rbf.logwidth),
            blr=blr_new, **noise)
    return TrainState(
        params=params,
        dynamics=dynamics,
        lik_n_sample=carry.lik_n.reshape(()).to(state_template.lik_n_sample.dtype),
    )


# ---------------------------------------------------------------------------
# Exact-inverse fallback of the prefix segment
# ---------------------------------------------------------------------------


def _member_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b``; where either has a leading member axis, member by member:
    on the card a batched product of these thin shapes takes other kernels
    than the solo one, with other bits (5e-6 on ``V g`` at the flagship,
    H100), which a fit amplifies. The square products agree bit for bit and
    stay batched."""
    if a.dim() <= 2 and b.dim() <= 2:
        return a @ b
    n = a.shape[0] if a.dim() > 2 else b.shape[0]
    return torch.stack([(a[m] if a.dim() > 2 else a) @ (b[m] if b.dim() > 2 else b)
                        for m in range(n)])


def _member_cholesky(p: torch.Tensor):
    """``cholesky_f32(p)``; with a leading member axis, member by member
    (see :func:`_exact_inverse_repair`)."""
    from .linalg import cholesky_f32

    if p.dim() <= 2:
        return cholesky_f32(p)
    chol, info = zip(*(cholesky_f32(x) for x in p))
    return torch.stack(chol), torch.stack(info)


def _exact_inverse_repair(cfg, c, prev_carry, g_vec, b, mse_fn):
    """Cholesky inverse of the current precision, refreshed weights, then the
    state-noise running variance from ``mse_fn(w_new)``. Gated so a failed
    factorization (``info != 0``), a non-finite result or an overflowing
    residual is SKIPPED; the gate reads the PRE-clip log-variance. Every
    leaf may carry a leading member axis (an ensemble's stacked carry): each
    member's P is then factored alone, because the card's batched
    factorisation takes another algorithm whose bits differ from the solo
    one's (by 1.6e-2 on a flagship P after the bootstrap, H100), which the
    fit amplifies, and the thin products go through :func:`_member_mm`; so
    member k keeps the bits of its solo fit."""
    from .linalg import tri_inv_newton

    chol, info = _member_cholesky(c.p_mat)
    x = tri_inv_newton(chol)
    v_new = x.mT @ x
    w_new = _member_mm(v_new, g_vec)
    mse = mse_fn(w_new)
    dyn_n = torch.clamp(prev_carry.dyn_n[..., 0, 0], max=float(cfg.state_var_cap))
    tot = dyn_n + b
    var = (dyn_n / tot) * torch.exp(prev_carry.state_logvar[..., 0, 0]) + (b / tot) * mse
    slv = torch.clamp(torch.log(var), -cfg.logvar_clamp, cfg.logvar_clamp)
    finite = torch.isfinite(torch.sum(v_new, dim=(-2, -1)) + torch.sum(w_new, dim=(-2, -1)))
    ok = (info == 0) & finite & torch.isfinite(var)
    ok2 = ok[..., None, None]
    return (
        torch.where(ok2, v_new, c.v_mat),
        torch.where(ok2, w_new, c.w_dyn),
        torch.where(ok, slv, c.state_logvar[..., 0, 0])[..., None, None],
        torch.where(ok, tot, c.dyn_n[..., 0, 0])[..., None, None],
    )


def exact_v_fallback(cfg: VJFConfig, out, prev_carry: FusedCarry,
                     u: Optional[torch.Tensor] = None, mask=None):
    """Replace the NS-tracked V with the exact Cholesky inverse where the
    step's tau says Newton-Schulz had not contracted (tau >=
    ``NS_TAU_THRESHOLD``).

    The JAX package branches with ``lax.cond``; here the exact branch is
    computed every call and selected with ``torch.where`` on the device, so
    the prefix never syncs with the host. ``prev_carry`` needs only the
    pre-step ``dyn_n`` and ``state_logvar`` (the per-step kernel updates the
    carry in place, so the caller snapshots those two). Under the step's
    trial ``mask`` the residual mse and the sample count run over the valid
    rows (a step without one reports tau 0, so the branch is never taken),
    and the features see the masked rows' controls as 0, as the step did.
    Deliberate deviation from the JAX package, whose fallback reads the
    controls as given: there a NaN-padded control makes the residual NaN
    and the exact inverse is skipped on every step with a masked trial.

    An ensemble step's output (:func:`fused_step_call` on a stacked carry)
    is taken as it is, each member's branch selected by its own tau;
    ``mask`` is then one copy for all members, ``u`` stacked or one copy.
    A call is the span ``vjf.fallback`` (:mod:`.trace`).
    """
    with _trace.span("vjf.fallback"):
        c = out.carry
        m_col = None if mask is None else _mask_col(mask, out.xt.dtype)
        b = out.xt.shape[-2] if m_col is None else torch.sum(m_col)
        if m_col is not None and u is not None:
            u = torch.where(m_col > 0, u, torch.zeros_like(u))

        def mse_fn(w_new):
            x2 = torch.sum(out.xs * out.xs, dim=-1, keepdim=True)
            cross = _member_mm(out.xs, c.cent_x.mT)
            if u is not None and u.shape[-1] > 0:
                x2 = x2 + torch.sum(u * u, dim=-1, keepdim=True)
                cross = cross + _member_mm(u, c.cent_u.mT)
            d2 = torch.clamp(x2 + c.c2 - 2.0 * cross, min=0.0)
            feat = torch.exp(-0.5 * d2 * c.inv_w2)
            if c.w_white is not None:
                feat = _member_mm(feat, c.w_white)          # SGP whitening
            resid = (out.xt - out.xs) - _member_mm(feat, w_new)
            if m_col is not None:
                return (torch.sum(resid * resid * m_col, dim=(-2, -1))
                        / (torch.clamp(b, min=1.0) * resid.shape[-1]))
            return torch.mean(resid * resid, dim=(-2, -1))

        exact = _exact_inverse_repair(cfg, c, prev_carry, out.g_vec, b, mse_fn)
        tau = out.scal.tau[0, 0] if isinstance(out, StepOut) else out.scal[..., 0, 4]
        return out._replace(carry=_select_exact(c, exact, tau))


def _select_exact(c: FusedCarry, exact, tau: torch.Tensor) -> FusedCarry:
    """``c`` with the exact-inverse repair's four leaves where ``tau >=
    NS_TAU_THRESHOLD``, selected on the device."""
    keep_ = (tau < NS_TAU_THRESHOLD)[..., None, None]
    v_new, w_new, slv, dn = (
        torch.where(keep_, k, e)
        for k, e in zip((c.v_mat, c.w_dyn, c.state_logvar, c.dyn_n), exact)
    )
    return c._replace(v_mat=v_new, w_dyn=w_new, state_logvar=slv, dyn_n=dn)


def exact_v_fallback_sums(cfg: VJFConfig, carry_new: FusedCarry, prev_carry: FusedCarry,
                          sums: FusedSums, g_vec: torch.Tensor, tau: torch.Tensor,
                          b_total) -> FusedCarry:
    """The exact-inverse fallback of the sharded step: as
    :func:`exact_v_fallback`, but the post-update residual comes from the
    all-reduced statistics (:func:`_stats_mse`), so no per-trial tensor
    crosses ranks. Computed every call and selected where ``tau >=
    NS_TAU_THRESHOLD``, with no host sync. ``prev_carry`` is the carry
    before :func:`step_apply` (its ``dyn_n`` and ``state_logvar``).
    ``b_total``: the batch, or under a trial mask the global valid count (a
    scalar tensor)."""
    b_div = torch.clamp(b_total, min=1.0) if isinstance(b_total, torch.Tensor) else b_total
    exact = _exact_inverse_repair(cfg, carry_new, prev_carry, g_vec, b_total,
                                  lambda w: _stats_mse(sums, w, b_div))
    return _select_exact(carry_new, exact, tau)


# ---------------------------------------------------------------------------
# Fused epoch runner
# ---------------------------------------------------------------------------


# the kernel limits already logged by fused_enabled, so each warns once
_routed_away = set()


def fused_enabled(cfg: VJFConfig, state, n_batch: Optional[int] = None,
                  mask: bool = False, channel_mask: bool = False,
                  launch_batch: Optional[int] = None) -> bool:
    """Whether ``run_epoch`` takes the fused path. 'auto' means float32, a
    state on a CUDA device (the JAX gate asks for a TPU backend) and a
    configuration within :func:`kernel_limits` at ``n_batch`` trials.

    The kernels take every shape the JAX package's TPU kernels take but a
    block past the card's shared memory at the smallest plan, which only an
    input or a layer far wider than any configuration of the repository, or
    hundreds of hidden layers, reach (:func:`kernel_limits`): every number
    of trials and of hidden layers, and at the flagship widths up to 1,792
    padded features. Deliberate deviation from the JAX package for such a
    block: under 'auto' such a configuration takes the
    autograd epoch, with one warning that names the limit; under 'on' the
    launch raises ``ValueError``. As in the JAX package, SGP below
    ``cfg.sgp_fused_min_batch`` trials takes the autograd epoch under
    'auto': a tiny batch keeps the Newton-Schulz trace bound hot, and that
    route has the per-step exact-inverse fallback. ``mask`` and
    ``channel_mask`` say whether the epoch carries them (their staging
    counts against the shared memory).

    ``launch_batch``: the trials one launch carries, where they are fewer
    than the batch ``n_batch`` (one rank's over several, the JAX package's
    ``shard_map`` block): the SGP gate and ``fused_step`` read the whole
    batch, the shared memory the launch's."""
    from ..models.regression import NSVBLR

    if cfg.fused_step == "off":
        return False
    if cfg.dynamics not in ("rbf", "sgp") or not isinstance(state.dynamics.blr, NSVBLR):
        return False
    if (cfg.dynamics == "sgp" and cfg.fused_step != "on" and n_batch is not None
            and n_batch < cfg.sgp_fused_min_batch):
        return False
    if cfg.dynamics_update != "rls":
        return False
    if cfg.recognition_activation != "tanh":
        return False
    if cfg.fused_step == "on":
        return True
    if not (cfg.dtype == "float32" and _on_cuda(state.dynamics.blr.precision)):
        return False
    launch = n_batch if launch_batch is None else launch_batch
    reason = kernel_limits(cfg, launch, on_card=launch is not None, mask=mask,
                           channel_mask=channel_mask)
    if reason is not None:
        if reason not in _routed_away:
            _routed_away.add(reason)
            logger.warning("fused_step='auto': %s; this configuration takes the autograd "
                           "epoch.", reason)
        return False
    return True


@contextlib.contextmanager
def full_f32_matmul():
    """Products on the card in full f32, no TF32, for the duration: the
    feedback chain (``P w``, Newton-Schulz, ``V g``, the exact fallback)
    must not lose bits. Restores the caller's settings on exit."""
    cuda, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = cuda.allow_tf32, cudnn.allow_tf32
    cuda.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        cuda.allow_tf32, cudnn.allow_tf32 = saved


def _lr_tensor(lr, dtype, device) -> torch.Tensor:
    if isinstance(lr, torch.Tensor):
        return lr.to(dtype=dtype, device=device).reshape(())
    return torch.full((), float(lr), dtype=dtype, device=device)


@full_f32_matmul()
def run_epoch_fused(cfg, flags, state, ys, us, seed, lr, noise=None,
                    q0=None, mask=None, channel_mask=None):
    """One epoch through the fused kernels -- same contract as
    ``models.vjf.run_epoch``.

    Layout (``cfg.fused_epoch``): 'mega' runs the first ``cfg.ns_prefix``
    RLS-active steps through the per-step kernel plus the exact-inverse
    fallback, and the rest of the epoch as ONE mega launch (warm-up epochs
    have no prefix); 'stepwise' runs every step through the per-step path.

    ``seed`` keys the Philox stream of the in-kernel noise (``noise=None``);
    ``noise=(eps_s, eps_t)``, each (T, B, xd), injects it instead. ``mask``
    (T, B) and ``channel_mask`` (T, B, ydim), already promoted, ride every
    step (the prefix's fallback takes the trial mask too).

    An ensemble, the counterpart of the JAX package's ``vmap`` over this
    epoch (``vjf_tpu/parallel/ensemble.py:115-125``): ``state`` a list of N
    ``TrainState``s and ``seed`` N ints. Their carries are stacked once, so
    every launch runs all N members (:func:`fused_step_call`), and
    :func:`exact_v_fallback` selects each member's branch by its own tau on
    the device. ``ys`` and ``us`` are (N, T, B, ...) per member or shared;
    ``noise`` and ``q0`` are stacked; the masks are shared. The result's
    ``state`` is then the list of N states and its tensors lead with the
    member axis.
    """
    from ..models.vjf import prior

    members = isinstance(state, list)         # a TrainState is a tuple too
    states = list(state) if members else [state]
    seeds = list(seed) if members else [seed]
    t_len, n_batch, _ = ys.shape[-3:]
    mask3 = _kernel_mask(mask, (t_len, n_batch))
    cmask3 = _kernel_mask(channel_mask, (t_len, n_batch, cfg.ydim))
    dtype, dev = ys.dtype, ys.device
    lr = _lr_tensor(lr, dtype, dev)
    us = us if cfg.udim > 0 else None

    do_fallback = flags.update and flags.update_transition and not flags.warm_up
    states = [maybe_epoch_repair(cfg, flags, st, n_batch) for st in states]
    carries = [pad_carry(cfg, st)._replace(
        rng_seed=torch.full((1, 1), int(s), dtype=torch.int32, device=dev))
        for st, s in zip(states, seeds)]
    carry = stack_carries(carries) if members else carries[0]
    if q0 is None:
        q0s = [prior(st.params, n_batch) for st in states]
        qm, qlv = (torch.stack(v) if members else v[0].contiguous() for v in zip(*q0s))
    else:
        qm, qlv = q0.mean.contiguous(), q0.logvar.contiguous()

    if cfg.fused_epoch == "mega":
        prefix = min(cfg.ns_prefix, t_len) if do_fallback else 0
    else:
        prefix = t_len
    eps_s, eps_t = (None, None) if noise is None else noise

    def at(x, lo, hi):
        """Steps [lo, hi) of an operand, stacked or not, as a launch reads it."""
        if x is None:
            return None
        return (x[lo:hi] if x.dim() == 3 else x[:, lo:hi]).contiguous()

    def now(x, t):
        return None if x is None else at(x, t, t + 1)[..., 0, :, :]

    q_segs, scal_segs = [], []
    with _trace.span("vjf.prefix") if prefix else _trace.NULL:
        for t in range(prefix):
            prev = carry._replace(dyn_n=carry.dyn_n.clone(),
                                  state_logvar=carry.state_logvar.clone())
            m_t = None if mask3 is None else mask3[t]
            out = fused_step_call(cfg, flags, carry, qm, qlv, now(ys, t), now(us, t),
                                  now(eps_s, t), now(eps_t, t), lr, mask=m_t,
                                  cmask=None if cmask3 is None else cmask3[t])
            if do_fallback:
                out = exact_v_fallback(cfg, out, prev, now(us, t), mask=m_t)
            carry = out.carry
            qm, qlv = (out.q_pack[..., i, :, :].contiguous() for i in (0, 1))
            q_segs.append(out.q_pack.unsqueeze(-4))
            scal_segs.append(out.scal)
    if prefix < t_len:
        carry, q_seq, scal = mega_epoch_call(
            cfg, flags, carry, qm, qlv, at(ys, prefix, t_len), at(us, prefix, t_len),
            at(eps_s, prefix, t_len), at(eps_t, prefix, t_len), lr,
            mask=None if mask3 is None else mask3[prefix:],
            cmask=None if cmask3 is None else cmask3[prefix:],
        )
        q_segs.append(q_seq)
        scal_segs.append(scal)

    q_seq, scal_seq = torch.cat(q_segs, dim=-4), torch.cat(scal_segs, dim=-2)
    bands = _trace.tau_bands(dev)
    if bands is not None:
        tau = scal_seq[..., 4]
        if do_fallback and prefix:
            bands[0].add_(tau_band_counts(tau[..., :prefix]))
        if prefix < t_len:
            bands[1].add_(tau_band_counts(tau[..., prefix:]))
    return epoch_result(cfg, carry, states if members else states[0], q_seq, scal_seq)


def tau_band_counts(tau: torch.Tensor) -> torch.Tensor:
    """The steps of ``tau`` (any shape: steps, members) in each band of the
    Newton-Schulz bound, (4,) int64 on its device: below
    ``NS_TAU_ESCALATE`` (the base iterations), up to ``NS_TAU_THRESHOLD``
    (one more), up to ``NS_TAU_MAX`` (three more; the prefix selects the
    exact fallback), and the rest with every tau that is not finite (the
    mega kernel skips the update; the prefix selects the fallback). Reads
    nothing back to the host."""
    t = torch.nan_to_num(tau.reshape(-1), nan=math.inf, neginf=math.inf)
    at_least = [(t >= x).sum() for x in (-math.inf, NS_TAU_ESCALATE, NS_TAU_THRESHOLD,
                                           NS_TAU_MAX)]
    at_least = torch.stack(at_least + [torch.zeros_like(at_least[0])])
    return at_least[:-1] - at_least[1:]


def epoch_result(cfg: VJFConfig, carry: FusedCarry, state, q_seq: torch.Tensor,
                 scal_seq: torch.Tensor):
    """An epoch's ``EpochResult`` from its final carry (unpadded against
    ``state``), its q packs (T, 2, B, xd) and its scalar rows (T, 8). A
    stacked carry, with the list of member states and both sequences led
    by the member axis: the list of the N new states."""
    from ..models.vjf import EpochResult, Metrics

    if n_members(carry):
        new = [unpad_carry(cfg, member_carry(carry, m), st) for m, st in enumerate(state)]
    else:
        new = unpad_carry(cfg, carry, state)
    metrics = Metrics(
        loss=scal_seq[..., 0],
        recon=scal_seq[..., 1],
        dynamics=scal_seq[..., 2],
        entropy=scal_seq[..., 3],
        tau=scal_seq[..., 4],
    )
    return EpochResult(
        state=new,
        q_means=q_seq[..., 0, :, :],
        q_logvars=q_seq[..., 1, :, :],
        metrics=metrics,
    )
