"""Streaming through the port's facade: ``VJF.filter_stream`` in both modes
against the JAX package's at float64 (the same numpy chunks, the state
carried across by ``convert``, each chunk's noise injected on both sides by
the order in which its key or seed first appears), one float32 case on the
fused route (JAX's Pallas kernels in interpret mode, the port's plain
versions), ``run_chunks``, the integer wire format, the demotion, and the
bit-exact resume from a ``StreamSnapshot``."""
import itertools
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vjf_tpu import api as japi
from vjf_tpu.models import vjf as jcore
from vjf_tpu_torch import VJF, StepFlags, convert
from vjf_tpu_torch.models import vjf as tcore
from vjf_tpu_torch.utils.checkpoint import load_snapshot

torch.set_num_threads(1)

YD, XD, NF, B, L = 6, 2, 8, 2, 8
KW = dict(n_rbf=NF, hidden_sizes=[3], likelihood="gaussian", dtype="float64",
          rls_backend="nsv", lr=1e-2)
# float64, the same algorithm; the JAX package weighs the state-noise
# running variance in float32 (the port in float64, a deliberate deviation),
# about 1e-8 relative a step, fed back through the dynamics term (the
# limit of tests/test_torch_filter.py's epochs)
TOL = dict(rtol=1e-6, atol=1e-7)
# float32 on the fused route: the limit of tests/test_torch_epoch.py for the
# fused epoch against the Pallas kernels in interpret mode
F32_TOL = dict(rtol=1e-3, atol=2e-4)


def _pair(**kw):
    kw = {**KW, **kw}
    jm = japi.VJF.make_model(YD, XD, **kw)
    tm = VJF.make_model(YD, XD, device="cpu", **kw)
    tm.state = convert.state_from_numpy(tm.cfg, jax.tree.map(np.asarray, jm.state),
                                        device="cpu")
    return jm, tm


def _draw(table, ident, shape, seed=0):
    """The noise of the ``i``-th distinct key or seed: a re-run of a chunk
    (the demotion) reuses its key, and so its noise."""
    i = table.setdefault(ident, len(table))
    return np.random.default_rng([seed, i]).normal(size=shape)


def _inject(monkeypatch, jm, tm, b=B):
    """Each epoch's noise on both sides (JAX's through a host callback, which
    runs at every execution of the jitted epoch), and each per-step filter
    draw of a tail chunk, in order."""
    tables = ({}, {})
    real_j, real_t = jcore.run_epoch, tcore.run_epoch

    def jrun(cfg, flags, state, ys, us, key, lr, noise=None, **kw):
        shape = (2, ys.shape[0], ys.shape[1], cfg.xdim)
        dt = np.dtype(cfg.dtype)
        eps = jax.pure_callback(
            lambda k: _draw(tables[0], np.asarray(k).tobytes(), shape).astype(dt),
            jax.ShapeDtypeStruct(shape, dt), key)
        return real_j(cfg, flags, state, ys, us, key, lr, noise=(eps[0], eps[1]), **kw)

    def trun(cfg, flags, state, ys, us, seed, lr, noise=None, **kw):
        eps = torch.tensor(_draw(tables[1], seed, (2, ys.shape[0], ys.shape[1], cfg.xdim)),
                           dtype=cfg.tdtype)
        return real_t(cfg, flags, state, ys, us, seed, lr, noise=(eps[0], eps[1]), **kw)

    monkeypatch.setattr(jcore, "run_epoch", jrun)
    monkeypatch.setattr(tcore, "run_epoch", trun)
    rng = np.random.default_rng(99)
    step_eps = [rng.normal(size=(2, b, XD)) for _ in range(64)]
    it_j, it_t = iter(step_eps), iter(step_eps)
    real_step = jm._step_fn

    def jstep(cfg, flags, st, qs, y, u, e_s, e_t, lr, **kw):
        e = next(it_j)
        return real_step(cfg, flags, st, qs, y, u, jnp.asarray(e[0], cfg.jdtype),
                         jnp.asarray(e[1], cfg.jdtype), lr, **kw)

    jm._step_fn = jstep
    monkeypatch.setattr(tm, "_normals", lambda n: torch.tensor(next(it_t), dtype=tm.cfg.tdtype))


def _chunks(n, seed=0, dtype=np.float64, t=L, b=B):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(t, b, YD)).astype(dtype) for _ in range(n)]


def _close(got, want, name, tol=TOL):
    np.testing.assert_allclose(np.asarray(torch.as_tensor(got), np.float64),
                               np.asarray(want, np.float64), err_msg=name, **tol)


def _compare(jout, tout, jm, tm, tol=TOL):
    assert len(tout) == len(jout)
    for i, (j, t) in enumerate(zip(jout, tout)):
        assert tuple(t.q_means.shape) == tuple(j.q_means.shape)
        _close(t.q_means, j.q_means, f"q_means {i}", tol)
        _close(t.q_logvars, j.q_logvars, f"q_logvars {i}", tol)
        _close(t.metrics.loss, j.metrics.loss, f"loss {i}", tol)
    a = convert.flatten(jax.tree.map(np.asarray, jm.state))
    b = convert.flatten(convert.state_to_numpy(tm.state))
    for k in a:
        _close(b[k], a[k], k, tol)


def _stream_case(case):
    """(model kwargs, filter_stream kwargs) of a case, from fresh data."""
    rng = np.random.default_rng(3)
    if case == "one":
        return {}, dict(chunks=_chunks(4))
    if case == "kblock":
        return {}, dict(chunks=_chunks(6), chunks_per_dispatch=2)
    if case in ("tail", "kblock_tail"):
        ch = _chunks(5)
        pairs = [(c, L) for c in ch[:-1]] + [(ch[-1], 5)]
        return {}, dict(chunks=pairs, chunks_per_dispatch=2 if case == "kblock_tail" else 1)
    if case in ("controls", "kblock_controls"):
        us = [rng.normal(size=(L, B, 1)) for _ in range(5)]
        return dict(udim=1), dict(chunks=_chunks(5), controls=us,
                                  chunks_per_dispatch=2 if case == "kblock_controls" else 1)
    # masks: a trial absent for a stretch, dead channels NaN in y
    ch = _chunks(5)
    ms, cms = [], []
    for c in ch:
        m = np.ones((L, B))
        m[2:5, 1] = 0.0
        cm = (rng.uniform(size=(L, B, YD)) > 0.2).astype(np.float64)
        c[cm == 0] = np.nan
        ms.append(m)
        cms.append(cm)
    return {}, dict(chunks=ch, masks=ms, channel_masks=cms,
                    chunks_per_dispatch=2 if case == "kblock_masks" else 1)


@pytest.mark.parametrize("case", ["one", "kblock", "tail", "kblock_tail", "controls",
                                  "kblock_controls", "masks", "kblock_masks"])
def test_filter_stream_matches_jax(monkeypatch, case):
    model_kw, kw = _stream_case(case)
    jm, tm = _pair(**model_kw)
    _inject(monkeypatch, jm, tm)
    chunks = kw.pop("chunks")
    jout = list(jm.filter_stream(iter(chunks), **kw))
    tout = list(tm.filter_stream(iter(chunks), **kw))
    _compare(jout, tout, jm, tm)
    if "tail" in case:
        assert tout[-1].q_means.shape[0] == 5


@pytest.mark.parametrize("k", [1, 2])
def test_filter_stream_f32_fused_matches_jax_interpret(monkeypatch, k):
    """float32 with ``fused_step='on'``: the first chunk's exact-inverse
    prefix and the mega segments, then (K 2) the prefix-free blocks; 8
    trials, as tests/test_torch_epoch.py (at 2 the weight mean is too
    poorly determined for a float32 comparison: 1.3% apart with the
    posteriors 5e-6 apart)."""
    kw = dict(dtype="float32", fused_step="on", matmul_dtype="float32", ns_prefix=4,
              demote_hot_frac=2.0)
    jm, tm = _pair(**kw)
    _inject(monkeypatch, jm, tm, b=8)
    chunks = _chunks(3, dtype=np.float32, b=8)
    jout = list(jm.filter_stream(iter(chunks), chunks_per_dispatch=k))
    tout = list(tm.filter_stream(iter(chunks), chunks_per_dispatch=k))
    assert all(r.metrics.tau is not None for r in tout), "the port left the fused route"
    _compare(jout, tout, jm, tm, F32_TOL)


def _f32_model(seed=3, **kw):
    base = dict(KW, dtype="float32", fused_step="on", ns_prefix=4, seed=seed)
    base.update(kw)
    return VJF.make_model(YD, XD, device="cpu", **base)


def test_run_chunks_matches_sequential_epochs():
    """K chunks in one ``run_chunks`` give the bits of K ``run_epoch`` calls
    with the posterior carried, and the hot fraction is the chunks' mean."""
    m = _f32_model()
    cfg = m.cfg.replace(ns_prefix=0)
    ys = torch.tensor(np.stack(_chunks(3, dtype=np.float32)))
    us = torch.zeros(3, L, B, 0)
    res = tcore.run_chunks(cfg, StepFlags(), m.state, ys, us, [5, 6, 7], 1e-2)
    state, q, hots = m.state, None, []
    for i in range(3):
        r = tcore.run_epoch(cfg, StepFlags(), state, ys[i], us[i], 5 + i, 1e-2, q0=q)
        assert torch.equal(res.q_means[i], r.q_means) and torch.equal(res.q_logvars[i],
                                                                        r.q_logvars)
        assert torch.equal(res.metrics.tau[i], r.metrics.tau)
        hots.append(tcore.epoch_tau_stats(cfg, r.metrics, L, torch.float32)[1])
        state, q = r.state, tcore.Gaussian(r.q_means[-1], r.q_logvars[-1])
    assert torch.equal(res.q_last.mean, q.mean)
    assert torch.equal(res.hot_frac, torch.mean(torch.stack(hots)))
    a, b = convert.flatten(convert.state_to_numpy(res.state)), \
        convert.flatten(convert.state_to_numpy(state))
    assert all(np.array_equal(a[k], b[k]) for k in a)


def test_wire_put_and_ingest():
    """The wire dtype crosses as it is when narrower, is cast on the host
    when wider, and is widened on the device by ``wire_ingest``."""
    y64 = np.linspace(0.0, 1.0, 24).reshape(4, 6)
    assert tcore.wire_put(y64, torch.float32, "cpu").dtype == torch.float32
    y8 = np.arange(24, dtype=np.uint8).reshape(4, 6)
    assert tcore.wire_put(y8, torch.float32, "cpu").dtype == torch.uint8
    got = tcore.wire_ingest(y8, torch.float32, "cpu")
    assert got.dtype == torch.float32 and torch.equal(got, torch.tensor(y8, dtype=torch.float32))
    assert torch.equal(tcore.wire_ingest(y64, torch.float32, "cpu"),
                       torch.tensor(y64.astype(np.float32)))
    t64 = torch.tensor(y64)
    assert tcore.wire_put(t64, torch.float32, "cpu").dtype == torch.float32
    assert tcore.wire_put(torch.tensor(y8), torch.float64, "cpu").dtype == torch.uint8


def _results_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x.q_means, y.q_means) and torch.equal(x.q_logvars, y.q_logvars)
        assert torch.equal(x.metrics.loss, y.metrics.loss)


def _same_state(m1, m2):
    a = convert.flatten(convert.state_to_numpy(m1.state))
    b = convert.flatten(convert.state_to_numpy(m2.state))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("fused", ["on", "off"])
@pytest.mark.parametrize("k", [1, 2])
def test_uint8_stream_gives_float32_bits(fused, k):
    """Counts sent as uint8 (a quarter of the float32 bytes) give the bits of
    the same counts sent as float32: they are widened on the device."""
    rng = np.random.default_rng(4)
    counts = [np.minimum(rng.poisson(0.8, size=(L, B, YD)), 255).astype(np.uint8)
              for _ in range(5)]
    outs, models = [], []
    for dt in (np.uint8, np.float32):
        m = _f32_model(likelihood="poisson", fused_step=fused)
        outs.append(list(m.filter_stream(iter([c.astype(dt) for c in counts]),
                                         chunks_per_dispatch=k)))
        models.append(m)
    _results_equal(*outs)
    _same_state(*models)


@pytest.mark.parametrize("k", [1, 2])
def test_hot_first_chunk_demotes_and_reruns(caplog, k):
    """A first chunk over the hot threshold demotes the stream to the
    autograd epoch and re-runs with the same seed: the result is the
    stream that took the autograd epoch from the start."""
    chunks = _chunks(5, dtype=np.float32)
    hot = _f32_model(demote_hot_frac=-1.0)
    with caplog.at_level(logging.WARNING, logger="vjf_tpu_torch.api"):
        out = list(hot.filter_stream(iter(chunks), chunks_per_dispatch=k))
    assert "demoting the stream to the autograd epoch and re-running" in caplog.text
    assert all(r.metrics.tau is None for r in out)
    plain = _f32_model(fused_step="off", demote_hot_frac=-1.0)
    _results_equal(out, list(plain.filter_stream(iter(chunks), chunks_per_dispatch=k)))
    _same_state(hot, plain)


def _hot_after(monkeypatch, n_cool):
    """``epoch_tau_stats`` reporting the first ``n_cool`` epochs as cool and
    every later one as wholly hot."""
    real = tcore.epoch_tau_stats
    calls = []

    def fake(cfg, metrics, t_len, dtype):
        calls.append(1)
        max_tau, hot = real(cfg, metrics, t_len, dtype)
        return max_tau, torch.full_like(hot, float(len(calls) > n_cool))

    monkeypatch.setattr(tcore, "epoch_tau_stats", fake)


def test_later_checks_resolve_one_chunk_late(monkeypatch, caplog):
    """After the first chunk, a hot chunk is read only once the next chunk
    is enqueued: chunk 2 is hot, chunk 3 still takes the mega layout, and
    the stream demotes from chunk 4 on."""
    _hot_after(monkeypatch, 1)
    m = _f32_model()
    with caplog.at_level(logging.WARNING, logger="vjf_tpu_torch.api"):
        out = list(m.filter_stream(iter(_chunks(5, dtype=np.float32))))
    assert [r.metrics.tau is not None for r in out] == [True, True, True, False, False]
    assert "the previous chunk's steps" in caplog.text


def test_final_hot_check_is_logged(monkeypatch, caplog):
    """The last chunk's deferred check is read when the stream ends."""
    _hot_after(monkeypatch, 1)
    m = _f32_model()
    with caplog.at_level(logging.WARNING, logger="vjf_tpu_torch.api"):
        out = list(m.filter_stream(iter(_chunks(2, dtype=np.float32))))
    assert all(r.metrics.tau is not None for r in out)
    assert "the stream ended before a demotion could apply" in caplog.text


@pytest.mark.parametrize("k,take,done", [(1, 2, 2), (2, 3, 3)])
def test_stream_resume_is_bit_exact(tmp_path, k, take, done):
    """Checkpoint, stop, resume on a model of another seed: the rest of the
    stream, the state, the learning rate and the generator are those of the
    uninterrupted stream. In K-block mode the first chunk runs alone and
    saves land on block boundaries."""
    chunks = _chunks(7, dtype=np.float32)
    ref = _f32_model()
    ref_out = list(ref.filter_stream(iter(chunks), chunks_per_dispatch=k))
    path = str(tmp_path / "stream.ckpt")
    part = _f32_model()
    gen = part.filter_stream(iter(chunks), chunks_per_dispatch=k, checkpoint_path=path,
                             checkpoint_every=2)
    list(itertools.islice(gen, take))
    gen.close()
    snap = load_snapshot(path, "cpu")
    assert snap.chunks_done == done and snap.k_block == k
    res = _f32_model(seed=99)
    out = list(res.filter_stream(iter(chunks[done:]), chunks_per_dispatch=k,
                                 resume_from=path))
    _results_equal(out, ref_out[done:])
    _same_state(res, ref)
    assert res._lr == ref._lr
    assert torch.equal(res.generator.get_state(), ref.generator.get_state())


def test_stream_resume_validation(tmp_path):
    chunks = _chunks(3, dtype=np.float32)
    path = str(tmp_path / "stream.ckpt")
    gen = _f32_model().filter_stream(iter(chunks), checkpoint_path=path, checkpoint_every=1)
    list(itertools.islice(gen, 1))
    gen.close()
    with pytest.raises(ValueError, match="chunks_per_dispatch"):
        list(_f32_model().filter_stream(iter(chunks[1:]), resume_from=path,
                                        chunks_per_dispatch=2))
    with pytest.raises(ValueError, match="warm_up"):
        list(_f32_model().filter_stream(iter(chunks[1:]), resume_from=path, warm_up=True))
    with pytest.raises(ValueError, match="different config"):
        list(_f32_model(lr=2e-2).filter_stream(iter(chunks[1:]), resume_from=path))
    with pytest.raises(ValueError, match="checkpoint_path"):
        list(_f32_model().filter_stream(iter(chunks), checkpoint_every=2))
    with pytest.raises(ValueError, match="checkpoint_every"):
        list(_f32_model().filter_stream(iter(chunks), checkpoint_path=path))
    fit_path = str(tmp_path / "fit.ckpt")
    m = _f32_model()
    m.fit(np.concatenate(chunks), max_iter=1, checkpoint_path=fit_path, checkpoint_every=1)
    with pytest.raises(ValueError, match="not a filter_stream snapshot"):
        list(m.filter_stream(iter(chunks), resume_from=fit_path))


def test_stream_side_iterables_are_checked():
    chunks = _chunks(2, dtype=np.float32)
    with pytest.raises(ValueError, match="udim=1"):
        list(_f32_model(udim=1).filter_stream(iter(chunks)))
    us = [np.zeros((L, B, 1), np.float32)]
    with pytest.raises(ValueError, match="controls.*ran out"):
        list(_f32_model(udim=1).filter_stream(iter(chunks), controls=iter(us)))
    with pytest.raises(ValueError, match="binary 0/1"):
        list(_f32_model().filter_stream(iter(chunks), masks=[np.full((L, B), 0.5)] * 2))
