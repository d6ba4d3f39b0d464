"""The port's associative-scan Kalman filter and smoother
(``vjf_tpu_torch/ops/pkalman.py``) against the JAX package's
(``vjf_tpu/ops/pkalman.py``) on the same numpy inputs, at float64 unless a
case says otherwise: the Gauss-Jordan inverse, the hand-written scan against
``jax.lax.associative_scan``, the parallel filter and smoother (dense R,
per-step dense R, diagonal R with missing entries, time-varying A and b)
against JAX's and against the port's own sequential loops, the batch axis,
and one float32 case."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vjf_tpu.ops import pkalman as JP
from vjf_tpu_torch.ops import pkalman as TP

torch.set_num_threads(1)

XD, YD, T, B = 2, 8, 24, 3
# float64, the same operations in the same order: only the summation order
# of the products differs
TOL = dict(rtol=1e-8, atol=1e-10)
# the parallel scan against the sequential loop: two algorithms
SEQ_TOL = dict(rtol=1e-7, atol=1e-10)
# float32 against JAX at float32
TOL32 = dict(rtol=1e-4, atol=0)

_j_smooth = jax.jit(JP.parallel_smooth, static_argnames=("diag_r",))
_j_seq = jax.jit(lambda a, q, h, r, m0, p0, ys, b: JP.sequential_smooth(
    a, q, JP.sequential_filter(a, q, h, r, m0, p0, ys, b), b))


def _close(got, want, tol=TOL, name=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), err_msg=name, **tol)


def _t(*xs):
    return [None if x is None else torch.tensor(x) for x in xs]


def _j(*xs):
    return [None if x is None else jnp.asarray(x) for x in xs]


def _system(seed=0, t_len=T, batch=()):
    """A stable rotation with noise, a random decoder, observations."""
    rng = np.random.default_rng(seed)
    th = 0.3
    a = 0.95 * np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    q = 0.1 * np.eye(XD) + 0.02 * np.ones((XD, XD))
    h = rng.normal(size=(YD, XD))
    r = 0.3 * np.eye(YD)
    m0, p0 = rng.normal(size=XD), np.diag([1.0, 0.5])
    ys = rng.normal(size=(t_len,) + batch + (YD,))
    return a, q, h, r, m0, p0, ys


def _time_varying(seed=1, t_len=T):
    rng = np.random.default_rng(seed)
    a = 0.9 * np.eye(XD) + 0.1 * rng.normal(size=(t_len, XD, XD))
    b = 0.2 * rng.normal(size=(t_len, XD))
    return a, b


CASES = ("dense", "dense_per_step", "diag_missing", "time_varying")


def _case(name):
    """(a, q, h, r, m0, p0, ys, b, diag_r) of a case, a time-invariant A in
    its (x, x) form and no b where the case has none."""
    a, q, h, r, m0, p0, ys = _system()
    b, diag = None, False
    rng = np.random.default_rng(5)
    if name == "dense_per_step":
        r = np.stack([np.diag(v) for v in rng.uniform(0.05, 0.5, size=(T, YD))])
    elif name == "diag_missing":
        r = rng.uniform(0.05, 0.5, size=(T, YD))
        miss = rng.random((T, YD)) < 0.2
        r[miss] = np.inf
        ys = ys.copy()
        ys[miss] = np.nan
        a, b = _time_varying(seed=2)
        diag = True
    elif name == "time_varying":
        a, b = _time_varying()
    return a, q, h, r, m0, p0, ys, b, diag


def _jax_args(a, q, h, r, m0, p0, ys, b):
    """JAX's operands with A and b per step: every case of one R form then
    shares one compiled program (JAX broadcasts a time-invariant A the same
    way inside)."""
    a = np.broadcast_to(a, (T, XD, XD)) if a.ndim == 2 else a
    b = np.zeros((T, XD)) if b is None else b
    return _j(a, q, h, r, m0, p0, ys, b)


@pytest.fixture(scope="module")
def jax_smooths():
    """JAX's results of each case; the per-step dense R through JAX's
    diagonal form of the same variances (JAX's own tests hold the two forms
    equal to 1e-9), so the cases take two compiled programs."""
    out = {}
    for name in CASES:
        a, q, h, r, m0, p0, ys, b, diag = _case(name)
        if name == "dense_per_step":
            r, diag = np.diagonal(r, axis1=-2, axis2=-1), True
        out[name] = _j_smooth(*_jax_args(a, q, h, r, m0, p0, ys, b), diag_r=diag)
    return out


def test_gj_inverse_matches_jax_and_numpy():
    """A random well-conditioned batch, a matrix that needs pivoting (a zero
    leading pivot) and one whose largest pivot sits low in every column."""
    rng = np.random.default_rng(7)
    m = np.eye(6) + 0.3 * rng.normal(size=(6, 6, 6))
    m[0] = np.eye(6)[[1, 2, 0, 4, 5, 3]] * np.arange(1.0, 7.0)
    m[1] = np.triu(np.ones((6, 6))) * 1e-3 + np.diag(np.arange(1.0, 7.0))[::-1]
    got = TP._gj_inverse(torch.tensor(m))
    _close(got, jax.jit(JP._gj_inverse)(jnp.asarray(m)))
    _close(got, np.linalg.inv(m), dict(rtol=1e-9, atol=1e-11))
    _close(got[:2], np.linalg.inv(m[:2]), dict(rtol=1e-12, atol=1e-14))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("t_len", [1, 2, 3, 7, 8])
def test_scan_matches_jax_associative_scan(t_len, reverse):
    """2x2 matrix products do not commute: the scan must combine the same
    elements in the same order and argument order."""
    m = np.random.default_rng(t_len).normal(size=(t_len, 2, 2))
    want = jax.jit(lambda x: jax.lax.associative_scan(jnp.matmul, x, reverse=reverse))(
        jnp.asarray(m))
    got, = TP.associative_scan(lambda a, b: (a[0] @ b[0],), (torch.tensor(m),),
                               reverse=reverse)
    _close(got, want)
    # the inclusive prefix products; reversed, fn(fn(z, y), x) = z @ y @ x
    ref = [m[0]] if not reverse else [m[-1]]
    for k in range(1, t_len):
        ref.append(ref[-1] @ m[k] if not reverse else ref[-1] @ m[t_len - 1 - k])
    _close(got, ref if not reverse else ref[::-1], SEQ_TOL)


@pytest.mark.parametrize("case", CASES)
def test_parallel_smooth_matches_jax_and_sequential(jax_smooths, case):
    a, q, h, r, m0, p0, ys, b, diag = _case(case)
    filt, sm = TP.parallel_smooth(*_t(a, q, h, r, m0, p0, ys, b), diag_r=diag)
    jf, js = jax_smooths[case]
    for got, want, name in ((filt.means, jf.means, "filtered means"),
                            (filt.covs, jf.covs, "filtered covs"),
                            (sm.means, js.means, "smoothed means"),
                            (sm.covs, js.covs, "smoothed covs")):
        assert torch.isfinite(got).all(), name
        _close(got, want, name=name)
    if diag:
        # the loops take a dense per-step R: a missing entry is a row of H,
        # R and y deleted, which a diagonal R of 0 weight is
        return
    seq_f = TP.sequential_filter(*_t(a, q, h, r, m0, p0, ys, b))
    seq_s = TP.sequential_smooth(*_t(a, q), seq_f, *_t(b))
    _close(filt.means, seq_f.means, SEQ_TOL)
    _close(filt.covs, seq_f.covs, SEQ_TOL)
    _close(sm.means, seq_s.means, SEQ_TOL)
    _close(sm.covs, seq_s.covs, SEQ_TOL)


def test_diag_missing_equals_deleted_channels_in_the_loops():
    """Diagonal R with ``inf`` entries against the sequential loops run on
    each step's observed channels only (a per-step loop here); the NaN
    values at the missing entries do not reach the result."""
    a, q, h, r, m0, p0, ys, b, _ = _case("diag_missing")
    _, sm = TP.parallel_smooth(*_t(a, q, h, r, m0, p0, ys, b), diag_r=True)
    m, p = torch.tensor(m0), torch.tensor(p0)
    at, bt, qt, ht = _t(a, b, q, h)
    ms, ps = [], []
    for t in range(T):
        keep = np.isfinite(r[t])
        mp, pp = at[t] @ m + bt[t], at[t] @ p @ at[t].T + qt
        hk = ht[keep]
        s = hk @ pp @ hk.T + torch.diag(torch.tensor(r[t][keep]))
        k = torch.linalg.solve(s, hk @ pp).T
        m = mp + k @ (torch.tensor(ys[t][keep]) - hk @ mp)
        p = (torch.eye(XD, dtype=torch.float64) - k @ hk) @ pp
        ms.append(m)
        ps.append(p)
    seq = TP.sequential_smooth(at, qt, TP.FilterResult(torch.stack(ms), torch.stack(ps)), bt)
    _close(sm.means, seq.means, SEQ_TOL)
    _close(sm.covs, seq.covs, SEQ_TOL)


@pytest.mark.parametrize("case", ["dense", "time_varying"])
def test_sequential_loops_match_jax(case):
    a, q, h, r, m0, p0, ys, b, _ = _case(case)
    want = _j_seq(*_jax_args(a, q, h, r, m0, p0, ys, b))
    seq_f = TP.sequential_filter(*_t(a, q, h, r, m0, p0, ys, b))
    got = TP.sequential_smooth(*_t(a, q), seq_f, *_t(b))
    _close(got.means, want.means)
    _close(got.covs, want.covs)


@pytest.mark.parametrize("diag", [False, True])
def test_batch_axis_equals_one_call_per_sequence(diag):
    """(T, B, ydim) in one call against B calls, with per-trial A and b and,
    for the diagonal form, per-trial variances; and a (T, x, x) A shared
    over the batch."""
    a, q, h, r, m0, p0, ys = _system(seed=3, batch=(B,))
    rng = np.random.default_rng(9)
    a_b = 0.9 * np.eye(XD) + 0.1 * rng.normal(size=(T, B, XD, XD))
    b_b = 0.2 * rng.normal(size=(T, B, XD))
    r_b = rng.uniform(0.05, 0.5, size=(T, B, YD)) if diag else r
    _, sm = TP.parallel_smooth(*_t(a_b, q, h, r_b, m0, p0, ys, b_b), diag_r=diag)
    a_s, _ = _time_varying(seed=4)
    _, shared = TP.parallel_smooth(*_t(a_s, q, h, r_b, m0, p0, ys), diag_r=diag)
    for i in range(B):
        r_i = r_b[:, i] if diag else r
        _, one = TP.parallel_smooth(*_t(a_b[:, i], q, h, r_i, m0, p0, ys[:, i], b_b[:, i]),
                                    diag_r=diag)
        _close(sm.means[:, i], one.means)
        _close(sm.covs[:, i], one.covs)
        _, one = TP.parallel_smooth(*_t(a_s, q, h, r_i, m0, p0, ys[:, i]), diag_r=diag)
        _close(shared.means[:, i], one.means)


def test_failed_factor_reads_nan_as_jax():
    """A singular innovation covariance: JAX's Cholesky gives NaN, and the
    port reads ``cholesky_ex``'s partial factor the same way."""
    a, q, h, _, m0, p0, ys = _system()
    r = -10.0 * np.eye(YD)
    _, sm = TP.parallel_smooth(*_t(a, q, h, r, m0, p0, ys))
    _, js = _j_smooth(*_jax_args(a, q, h, r, m0, p0, ys, None), diag_r=False)
    assert np.isnan(np.asarray(js.means)).all()
    assert torch.isnan(sm.means).all()


def test_float32_matches_jax_float32():
    """The card's dtype: the Gauss-Jordan inverse and both combines on a
    batch of the diagonal case's elements, both packages at float32."""
    a, q, h, r, m0, p0, ys, b, _ = _case("diag_missing")
    f64 = TP._filter_elements_diag(*_t(a, q, h, r, m0, p0, ys, b))
    e32 = [x.to(torch.float32) for x in f64]
    ei, ej = tuple(x[:-1] for x in e32), tuple(x[1:] for x in e32)
    s32 = tuple(x.to(torch.float32) for x in TP._smooth_elements(
        *_t(a, q), TP.FilterResult(f64[1], f64[2]), *_t(b)))
    si, sj = tuple(x[:-1] for x in s32), tuple(x[1:] for x in s32)

    def jax_side(ei, ej, si, sj):
        return (JP._gj_inverse(ei[2] + ej[4]), JP._filter_combine(ei, ej),
                JP._smooth_combine(sj, si))

    def port_side(ei, ej, si, sj):
        return (TP._gj_inverse(ei[2] + ej[4]), TP._filter_combine(ei, ej),
                TP._smooth_combine(sj, si))

    want = jax.jit(jax_side)(*(tuple(jnp.asarray(x.numpy()) for x in e)
                               for e in (ei, ej, si, sj)))
    got = port_side(ei, ej, si, sj)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.dtype == torch.float32 and w.dtype == jnp.float32
        _close(g, w, TOL32)
