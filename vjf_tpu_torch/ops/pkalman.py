"""Parallel-in-time Kalman filtering and RTS smoothing by associative scan
(counterpart of ``vjf_tpu/ops/pkalman.py``).

For a (locally) linear-Gaussian state-space model, Kalman filtering and
smoothing are associative operations (Sarkka & Garcia-Fernandez, "Temporal
Parallelization of Bayesian Smoothers", IEEE TAC 2021), so a scan over time
runs them in O(log T) depth:

    x[t] = A x[t-1] + b[t] + N(0, Q),   y[t] = H x[t] + N(0, R),  x[0] ~ N(m0, P0)

Five-tuple filtering elements ``(A, b, C, eta, J)`` compose as conditional
Gaussians; three-tuple smoothing elements ``(E, g, L)`` compose backward.

Every function takes a batch axis of its own: time first, then any batch
dims, then the matrix dims. ``ys`` is (T, *batch, ydim); a per-step operand
is (T, *batch, ...) or (T, ...) shared over the batch, a time-invariant one
has the matrix dims alone. ``q``, ``h``, ``m0`` and ``p0`` are shared. One
call smooths a whole batch of trials.

torch has no associative scan: :func:`associative_scan` mirrors the
recursion of ``jax.lax.associative_scan``, so the two packages combine the
same elements in the same tree. The entry points run with TF32 off (the
covariance recursions must keep full f32 on the card).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Sequence, Tuple

import torch

from .fused_step import full_f32_matmul
from .linalg import nan_where_failed


class FilterResult(NamedTuple):
    means: torch.Tensor   # (T, *batch, xdim) filtered means
    covs: torch.Tensor    # (T, *batch, xdim, xdim) filtered covariances


class SmoothResult(NamedTuple):
    means: torch.Tensor
    covs: torch.Tensor


def _gj_inverse(m: torch.Tensor) -> torch.Tensor:
    """Batched inverse of small matrices by unrolled Gauss-Jordan with
    partial pivoting: n passes of batched elementwise and gather work, no
    LU call. The same sequence of operations as the JAX package's (whose
    batched LU is a serial per-matrix loop on a TPU), so both give the same
    roundings; the combine's matrices ``I + C J`` have eigenvalues >= 1."""
    n = m.shape[-1]
    eye = torch.eye(n, dtype=m.dtype, device=m.device)
    aug = torch.cat([m, eye.expand(m.shape)], dim=-1)
    rows = torch.arange(n, device=m.device)
    for k in range(n):
        # partial pivot: the strongest remaining row in column k
        col = torch.where(rows >= k, aug[..., :, k].abs(), -torch.inf)
        pk = col.argmax(dim=-1, keepdim=True)
        rows_b = rows.expand(aug.shape[:-2] + (n,))
        swapped = torch.where(rows_b == k, pk, torch.where(rows_b == pk, k, rows_b))
        aug = torch.take_along_dim(aug, swapped[..., None], dim=-2)
        # normalise the pivot row, eliminate column k from every other row
        prow = aug[..., k:k + 1, :] / aug[..., k:k + 1, k:k + 1]
        fac = aug[..., :, k:k + 1]
        aug = torch.where((rows == k)[:, None], prow, aug - fac * prow)
    return aug[..., :, n:]


def _mv(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product."""
    return (m @ v[..., None])[..., 0]


def _t(m: torch.Tensor) -> torch.Tensor:
    return m.transpose(-1, -2)


def _sym(m: torch.Tensor) -> torch.Tensor:
    return 0.5 * (m + _t(m))


def _seq(v: torch.Tensor, t_len: int, batch: Tuple[int, ...], core: int) -> torch.Tensor:
    """A time-invariant operand (its ``core`` trailing dims alone), a per-step
    one shared over the batch (T, core dims) or a per-trial one (T, *batch,
    core dims), as a (T, *batch, core dims) view."""
    tail = tuple(v.shape[v.ndim - core:])
    if v.ndim == core:
        v = v.reshape((1,) * (1 + len(batch)) + tail)
    elif v.ndim == core + 1:
        v = v.reshape((v.shape[0],) + (1,) * len(batch) + tail)
    return v.expand((t_len,) + tuple(batch) + tail)


def _broadcast_a(a, t_len, batch):
    """A time-invariant (x, x) or per-step (T, [*batch,] x, x) transition."""
    return _seq(a, t_len, batch, 2)


def _broadcast_b(b, t_len, batch, xdim, dtype, device):
    if b is None:
        return torch.zeros((t_len,) + tuple(batch) + (xdim,), dtype=dtype, device=device)
    return _seq(b, t_len, batch, 1)


def _set_first(v: torch.Tensor, first: torch.Tensor) -> torch.Tensor:
    """``v`` with step 0 replaced by ``first``."""
    return torch.cat([first.expand(v.shape[1:])[None], v[1:]])


def _cholesky(s: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor, NaN throughout where it fails (as JAX's)."""
    chol, info = torch.linalg.cholesky_ex(s)
    return nan_where_failed(chol, info)


def _cho_solve(chol: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    shape = torch.broadcast_shapes(chol.shape[:-2], rhs.shape[:-2])
    return torch.cholesky_solve(rhs.expand(shape + rhs.shape[-2:]),
                                chol.expand(shape + chol.shape[-2:]))


def _first_element(a_seq, b_seq, q, m0, p0):
    """The prior's prediction of step 0: ``(m1-, P1-)``."""
    a0 = a_seq[0]
    m1m = _mv(a0, m0) + b_seq[0]
    p1m = a0 @ p0 @ _t(a0) + q
    return m1m, p1m


def _filter_elements(a, q, h, r, m0, p0, ys, b=None):
    """Per-step associative elements (eqs. 10-12 of the paper). ``a[t]`` maps
    x[t-1] to x[t], ``b[t]`` its affine offset; ``r`` is a dense (ydim, ydim)
    covariance or a per-step (T, [*batch,] ydim, ydim) one."""
    t_len, batch = ys.shape[0], tuple(ys.shape[1:-1])
    xdim = q.shape[0]
    eye = torch.eye(xdim, dtype=q.dtype, device=q.device)
    a_seq = _broadcast_a(a, t_len, batch)
    b_seq = _broadcast_b(b, t_len, batch, xdim, q.dtype, q.device)
    hq = h @ q

    if r.ndim == 2:
        # time-invariant observation side: factor once
        s_chol = _cholesky(h @ q @ h.T + r)
        k = _cho_solve(s_chol, hq).T                          # K = Q H^T S^-1
        i_kh = eye - k @ h
        c_el = _sym(i_kh @ q)
        hs_inv_h = _sym(h.T @ _cho_solve(s_chol, h))

        def s_inv(v):   # one solve, the steps and trials as its columns
            return _cho_solve(s_chol, v.reshape(-1, v.shape[-1]).T).T.reshape(v.shape)

        j_t = _t(a_seq) @ hs_inv_h @ a_seq
        c_t = c_el.expand(a_seq.shape)
    else:
        r_seq = _seq(r, t_len, batch, 2)
        s_chol = _cholesky(h @ q @ h.T + r_seq)
        k = _t(_cho_solve(s_chol, hq))
        i_kh = eye - k @ h

        def s_inv(v):
            return _cho_solve(s_chol, v[..., None])[..., 0]

        j_t = _t(a_seq) @ (h.T @ _cho_solve(s_chol, h)) @ a_seq
        c_t = _sym(i_kh @ q)
    b_out = _mv(i_kh, b_seq) + _mv(k, ys)
    innov = ys - _mv(h, b_seq)
    eta = _mv(_t(a_seq) @ h.T, s_inv(innov))
    a_g = i_kh @ a_seq

    # the first element conditions on the prior
    r0 = r if r.ndim == 2 else r_seq[0]
    m1m, p1m = _first_element(a_seq, b_seq, q, m0, p0)
    s1_chol = _cholesky(h @ p1m @ h.T + r0)
    k1 = _t(_cho_solve(s1_chol, h @ p1m))
    b1 = m1m + _mv(k1, ys[0] - _mv(h, m1m))
    c1 = _sym((eye - k1 @ h) @ p1m)
    zero_m = torch.zeros((xdim, xdim), dtype=q.dtype, device=q.device)
    zero_v = torch.zeros((xdim,), dtype=q.dtype, device=q.device)
    return (_set_first(a_g, zero_m), _set_first(b_out, b1), _set_first(c_t, c1),
            _set_first(eta, zero_v), _set_first(_sym(j_t), zero_m))


def _filter_elements_diag(a, q, h, r, m0, p0, ys, b=None):
    """Per-step elements for DIAGONAL per-step observation noise ``r``,
    (ydim,) or (T, [*batch,] ydim) variances, in information form: with
    weights ``w = 1/r``, ``Phi_t = H^T diag(w_t) H`` and ``z_t = H^T (w_t *
    y_t)``, every S_t^-1 application becomes an xdim-by-xdim solve::

        K_t H = M_t^-1 Phi_t,   K_t y_t = M_t^-1 z_t,
        H^T S_t^-1 = Q^-1 M_t^-1 H^T diag(w_t),   M_t = Q^-1 + Phi_t

    so nothing of size (ydim, ydim) is built per step. An ``inf`` variance
    (a missing observation) has weight exactly 0, and its ``ys`` value may
    be NaN."""
    t_len, batch = ys.shape[0], tuple(ys.shape[1:-1])
    xdim = q.shape[0]
    eye = torch.eye(xdim, dtype=q.dtype, device=q.device)
    a_seq = _broadcast_a(a, t_len, batch)
    b_seq = _broadcast_b(b, t_len, batch, xdim, q.dtype, q.device)
    r_seq = _seq(torch.as_tensor(r, dtype=q.dtype, device=q.device), t_len, batch, 1)
    w = torch.where(torch.isfinite(r_seq), 1.0 / r_seq, 0.0)
    y_safe = torch.where(w > 0, ys, 0.0)                      # NaN-safe
    z = (w * y_safe) @ h                                      # (T, *batch, x)
    phi = (h.T * w[..., None, :]) @ h                         # (T, *batch, x, x)
    q_inv = _gj_inverse(q)

    # one inverse and one stacked full-precision application in place of
    # three factorisations
    m_inv = _gj_inverse(q_inv + phi)
    rhs = torch.cat([phi, z[..., None], (z - _mv(phi, b_seq))[..., None]], dim=-1)
    sol = m_inv @ rhs
    kh = sol[..., :xdim]                                      # K_t H
    i_kh = eye - kh
    b_out = _mv(i_kh, b_seq) + sol[..., xdim]
    eta = _mv(_t(a_seq), _mv(q_inv, sol[..., xdim + 1]))
    j = _sym(_t(a_seq) @ (q_inv @ kh) @ a_seq)
    c_t = _sym(i_kh @ q)
    a_g = i_kh @ a_seq

    # the first element conditions on the prior (information form again)
    m1m, p1m = _first_element(a_seq, b_seq, q, m0, p0)
    p1m_inv = _gj_inverse(p1m)
    c1 = _sym(_gj_inverse(p1m_inv + phi[0]))
    b1 = _mv(c1, _mv(p1m_inv, m1m) + z[0])
    zero_m = torch.zeros((xdim, xdim), dtype=q.dtype, device=q.device)
    zero_v = torch.zeros((xdim,), dtype=q.dtype, device=q.device)
    return (_set_first(a_g, zero_m), _set_first(b_out, b1), _set_first(c_t, c1),
            _set_first(eta, zero_v), _set_first(j, zero_m))


def _filter_combine(ei, ej):
    """(A, b, C, eta, J)_i then _j: eq. 9 of the paper. With C and J
    symmetric, ``N = I + J C = M^T`` for ``M = I + C J``, so one inverse of
    M serves every solve, applied to M's right-hand sides and, transposed,
    to N's."""
    ai, bi, ci, etai, ji = ei
    aj, bj, cj, etaj, jj = ej
    xdim = ai.shape[-1]
    eye = torch.eye(xdim, dtype=ai.dtype, device=ai.device)

    m_inv = _gj_inverse(eye + ci @ jj)
    bc = bi[..., None] + ci @ etaj[..., None]                 # (..., x, 1)
    sol_m = m_inv @ torch.cat([ai, bc, ci], dim=-1)           # (..., x, 2x+1)
    a_out = aj @ sol_m[..., :xdim]
    b_out = (aj @ sol_m[..., xdim:xdim + 1])[..., 0] + bj
    c_out = _sym(aj @ sol_m[..., xdim + 1:] @ _t(aj) + cj)

    nb = (etaj - (jj @ bi[..., None])[..., 0])[..., None]
    sol_n = _t(m_inv) @ torch.cat([nb, jj @ ai], dim=-1)      # (..., x, x+1)
    ait = _t(ai)
    eta_out = (ait @ sol_n[..., :1])[..., 0] + etai
    j_out = _sym(ait @ sol_n[..., 1:] + ji)
    return a_out, b_out, c_out, eta_out, j_out


def associative_scan(fn: Callable, elems: Sequence[torch.Tensor],
                     reverse: bool = False) -> Tuple[torch.Tensor, ...]:
    """Inclusive scan of the tuple ``elems`` along dim 0 under the
    associative ``fn(earlier, later)``: the recursion of
    ``jax.lax.associative_scan`` (pairs, recurse on the pairs, combine the
    odd results with the even elements, interleave), so the same tree of
    combines. ``reverse`` flips time on the way in and out and keeps the
    argument order of ``fn``."""
    elems = tuple(elems)
    if reverse:
        elems = tuple(torch.flip(e, (0,)) for e in elems)

    def scan(els):
        n = els[0].shape[0]
        if n < 2:
            return els
        odd = scan(tuple(fn(tuple(e[0:-1:2] for e in els), tuple(e[1::2] for e in els))))
        tail = tuple(e[2::2] for e in els)
        if tail[0].shape[0]:
            left = odd if n % 2 else tuple(o[:-1] for o in odd)
            even = tuple(torch.cat([e[:1], c]) for e, c in zip(els, fn(left, tail)))
        else:
            even = tuple(e[:1] for e in els)
        out = []
        for e, o in zip(even, odd):
            full = e.new_empty((e.shape[0] + o.shape[0],) + tuple(e.shape[1:]))
            full[0::2], full[1::2] = e, o
            out.append(full)
        return tuple(out)

    out = scan(elems)
    return tuple(torch.flip(e, (0,)) for e in out) if reverse else out


@full_f32_matmul()
def parallel_filter(a, q, h, r, m0, p0, ys, b=None, *, diag_r: bool = False) -> FilterResult:
    """Kalman filter of (T, *batch, ydim) observations in O(log T) depth.

    ``diag_r=True``: ``r`` holds diagonal observation VARIANCES, (ydim,) or
    per step (T, [*batch,] ydim); ``inf`` marks a missing observation
    (weight exactly 0). Otherwise ``r`` is a dense (ydim, ydim) or per-step
    (T, [*batch,] ydim, ydim) covariance."""
    make = _filter_elements_diag if diag_r else _filter_elements
    _, b_s, c_s, _, _ = associative_scan(_filter_combine, make(a, q, h, r, m0, p0, ys, b))
    return FilterResult(means=b_s, covs=c_s)


def _smooth_elements(a, q, filtered: FilterResult, b=None):
    """Backward elements (E, g, L): x_t | x_{t+1} ~ N(E x_{t+1} + g, L). The
    gain at t uses the transition INTO t+1, ``a[t+1]`` and ``b[t+1]``."""
    t_len, batch = filtered.means.shape[0], tuple(filtered.means.shape[1:-1])
    xdim = q.shape[0]
    a_next = torch.roll(_broadcast_a(a, t_len, batch), -1, dims=0)
    b_next = torch.roll(_broadcast_b(b, t_len, batch, xdim, q.dtype, q.device), -1, dims=0)
    m, p = filtered.means, filtered.covs
    ap = a_next @ p
    pp = _sym(ap @ _t(a_next) + q)
    e = _t(_gj_inverse(pp) @ ap)                              # G = P A^T Pp^-1
    g = m - _mv(e, _mv(a_next, m) + b_next)
    l_el = _sym(p - e @ pp @ _t(e))
    # the last element: the filtered terminal state
    return tuple(torch.cat([v[:-1], last[None]])
                 for v, last in ((e, torch.zeros_like(e[-1])), (g, m[-1]), (l_el, p[-1])))


def _smooth_combine(ej, ei):
    """Compose x_i = E_i x_j + g_i, backward."""
    ei_e, ei_g, ei_l = ei
    ej_e, ej_g, ej_l = ej
    return (ei_e @ ej_e, (ei_e @ ej_g[..., None])[..., 0] + ei_g,
            ei_e @ ej_l @ _t(ei_e) + ei_l)


@full_f32_matmul()
def parallel_smooth(a, q, h, r, m0, p0, ys, b=None, *,
                    diag_r: bool = False) -> Tuple[FilterResult, SmoothResult]:
    """RTS smoother in two associative scans (filter forward, smooth
    backward). ``diag_r``: see :func:`parallel_filter`."""
    filtered = parallel_filter(a, q, h, r, m0, p0, ys, b, diag_r=diag_r)
    _, g_s, l_s = associative_scan(_smooth_combine, _smooth_elements(a, q, filtered, b),
                                   reverse=True)
    return filtered, SmoothResult(means=g_s, covs=l_s)


@full_f32_matmul()
def sequential_filter(a, q, h, r, m0, p0, ys, b=None) -> FilterResult:
    """O(T) reference loop. ``r`` dense (ydim, ydim) or per step."""
    t_len, batch = ys.shape[0], tuple(ys.shape[1:-1])
    xdim = q.shape[0]
    eye = torch.eye(xdim, dtype=q.dtype, device=q.device)
    a_seq = _broadcast_a(a, t_len, batch)
    b_seq = _broadcast_b(b, t_len, batch, xdim, q.dtype, q.device)
    r_seq = None if r.ndim == 2 else _seq(r, t_len, batch, 2)
    m, p = m0, p0
    ms, ps = [], []
    for t in range(t_len):
        a_t = a_seq[t]
        mp = _mv(a_t, m) + b_seq[t]
        pp = a_t @ p @ _t(a_t) + q
        s = h @ pp @ h.T + (r if r_seq is None else r_seq[t])
        k = _t(torch.linalg.solve(s, h @ pp))
        m = mp + _mv(k, ys[t] - _mv(h, mp))
        p = (eye - k @ h) @ pp
        ms.append(m)
        ps.append(p)
    return FilterResult(means=torch.stack(ms), covs=torch.stack(ps))


@full_f32_matmul()
def sequential_smooth(a, q, filtered: FilterResult, b=None) -> SmoothResult:
    """O(T) RTS reference loop."""
    t_len, batch = filtered.means.shape[0], tuple(filtered.means.shape[1:-1])
    a_seq = _broadcast_a(a, t_len, batch)
    b_seq = _broadcast_b(b, t_len, batch, q.shape[0], q.dtype, q.device)
    m_s, p_s = filtered.means[-1], filtered.covs[-1]
    ms, ps = [m_s], [p_s]
    for t in range(t_len - 2, -1, -1):
        a_n, b_n = a_seq[t + 1], b_seq[t + 1]
        m, p = filtered.means[t], filtered.covs[t]
        pp = a_n @ p @ _t(a_n) + q
        g = _t(torch.linalg.solve(pp, a_n @ p))
        m_s = m + _mv(g, m_s - _mv(a_n, m) - b_n)
        p_s = p + g @ (p_s - pp) @ _t(g)
        ms.append(m_s)
        ps.append(p_s)
    return SmoothResult(means=torch.stack(ms[::-1]), covs=torch.stack(ps[::-1]))
