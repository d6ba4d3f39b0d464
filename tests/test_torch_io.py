"""The port's checkpoints and snapshots (``utils.checkpoint``), the fit's
resume, the native streaming loader and ``device_prefetch``, and the
metrics and debugging utilities."""
import io
import json
import logging
import os
import pickle
import threading
import time

import numpy as np
import pytest
import torch

from vjf_tpu import config as jcfg
from vjf_tpu.utils import checkpoint as jckpt
from vjf_tpu_torch import StepFlags, VJFConfig, convert
from vjf_tpu_torch.models import vjf as tcore
from vjf_tpu_torch.native import loader as L
from vjf_tpu_torch.native import StreamingLoader, device_prefetch
from vjf_tpu_torch.utils import (MetricsWriter, StepTimer, multiplex, profiler_trace,
                                 progress_callback)
from vjf_tpu_torch.utils import checkpoint as C
from vjf_tpu_torch.utils.debugging import (assert_all_finite, debug_finite_callback,
                                           enable_nan_debugging)

torch.set_num_threads(1)

T, B = 24, 2


def _cfg(**kw):
    base = dict(ydim=5, xdim=2, n_rbf=6, hidden_sizes=(3,), likelihood="gaussian",
                dtype="float32", rls_backend="nsv", fused_step="on", ns_prefix=4, lr=1e-2,
                warmup_max=2)
    base.update(kw)
    return VJFConfig(**base)


def _data(seed=0, t=T):
    return np.random.default_rng(seed).normal(size=(t, B, 5)).astype(np.float32)


def _leaves(state):
    return convert.flatten(convert.state_to_numpy(state))


def _assert_same(a_state, b_state):
    a, b = _leaves(a_state), _leaves(b_state)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(), dict(rls_backend="precision", dtype="float64"),
                                dict(rls_backend="covariance"),
                                dict(dynamics="sgp", n_inducing=5, likelihood="poisson")])
def test_checkpoint_round_trip(tmp_path, kw):
    """State, config and loop come back with every leaf's bits, dtype and
    type; the file is one file, and no ``.tmp`` is left behind."""
    cfg = _cfg(**kw)
    state = tcore.init_state(0, cfg, device="cpu")
    gen = torch.Generator().manual_seed(5)
    torch.randn(3, generator=gen)
    loop = C.FitLoopState(epoch=3, lr=1e-3 / 3, warm_up=False, running_loss=float("nan"),
                          generator=gen)
    path = str(tmp_path / "ckpt")
    C.save_checkpoint(path, state, cfg=cfg, loop=loop)
    assert os.listdir(tmp_path) == ["ckpt"]
    got, got_loop = C.load_checkpoint(path, device="cpu")
    assert type(got.dynamics) is type(state.dynamics)
    assert type(got.dynamics.blr) is type(state.dynamics.blr)
    _assert_same(state, got)
    assert (got_loop.epoch, got_loop.lr, got_loop.warm_up) == (3, 1e-3 / 3, False)
    assert np.isnan(got_loop.running_loss)
    assert torch.equal(got_loop.generator.get_state(), gen.get_state())
    assert C.load_config(path) == cfg
    C.save_checkpoint(path, state)
    assert C.load_checkpoint(path, device="cpu")[1] is None
    with pytest.raises(ValueError, match="without its config"):
        C.load_config(path)


def test_checkpoint_resume_continues_identically(tmp_path):
    cfg = _cfg()
    state = tcore.init_state(0, cfg, device="cpu")
    ys, us = torch.tensor(_data()), torch.zeros(T, B, 0)

    def epoch(st):
        return tcore.run_epoch(cfg, StepFlags(), st, ys, us, 7, 1e-2).state

    straight = epoch(epoch(state))
    path = str(tmp_path / "mid")
    C.save_checkpoint(path, epoch(state))
    mid, loop = C.load_checkpoint(path, device="cpu")
    assert loop is None
    _assert_same(straight, epoch(mid))


def test_load_config_drops_unknown_fields_with_a_warning(tmp_path):
    path = str(tmp_path / "ckpt")
    C.save_checkpoint(path, tcore.init_state(0, _cfg(), device="cpu"), cfg=_cfg())
    payload = torch.load(path, weights_only=True)
    payload["cfg"]["mega_unroll"] = 4
    torch.save(payload, path)
    with pytest.warns(UserWarning, match="mega_unroll"):
        assert C.load_config(path) == _cfg()


def test_loading_refuses_what_it_did_not_write(tmp_path):
    """A file of another format, a NamedTuple type outside the package, and
    a pickled object (``weights_only`` loading) are refused."""
    path = str(tmp_path / "f")
    torch.save({"state": 1}, path)
    with pytest.raises(ValueError, match="not a vjf_tpu_torch checkpoint"):
        C.load_checkpoint(path, device="cpu")
    torch.save({"format": C._FORMAT, "kind": "snapshot",
                "snapshot": {"__namedtuple__": "collections:namedtuple", "fields": {}}}, path)
    with pytest.raises(ValueError, match="outside vjf_tpu_torch"):
        C.load_snapshot(path, device="cpu")
    with open(path, "wb") as f:
        torch.save(io.StringIO("an object"), f)
    with pytest.raises(pickle.UnpicklingError):
        C.load_snapshot(path, device="cpu")
    C.save_checkpoint(path, tcore.init_state(0, _cfg(), device="cpu"))
    with pytest.raises(ValueError, match="not a fit or stream snapshot"):
        C.load_snapshot(path, device="cpu")


@pytest.mark.parametrize("kw", [dict(ydim=5, xdim=2), dict(ydim=200, xdim=10, n_rbf=100,
                                                           hidden_sizes=(32,), dtype="float32",
                                                           likelihood="poisson"),
                                dict(ydim=20, xdim=2, dynamics="sgp", rls_shrink=0.999,
                                     chol_jitter=1e-3, select="forecast")])
def test_config_digest_equals_jax(kw):
    """The same md5 of the same JSON as the JAX package's digest."""
    port, ref = VJFConfig(**kw), jcfg.VJFConfig(**kw)
    assert C.config_digest(port) == bytes(jckpt.config_digest(ref)).hex()
    assert C.config_digest(port) != C.config_digest(port.replace(lr=2e-4))


# ---------------------------------------------------------------------------
# fit snapshots
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k,select", [(1, "loss"), (2, "loss"), (1, "forecast"),
                                      (2, "forecast")])
def test_fit_resume_is_bit_exact(tmp_path, k, select):
    """A fit interrupted after its snapshot and resumed (from another state
    and seed, which the snapshot supersedes) ends where the uninterrupted
    fit ends, bit for bit: the warm-up, the bootstrap's draw, the learning
    rate, the selection stream."""
    cfg = _cfg(select=select, select_horizon=5, select_starts=4)
    y = _data()
    state = tcore.init_state(0, cfg, device="cpu")
    ref = tcore.fit(cfg, state, y, seed=3, max_iter=6, epochs_per_dispatch=k)
    path = str(tmp_path / "fit.ckpt")
    tcore.fit(cfg, state, y, seed=3, max_iter=4, epochs_per_dispatch=k,
              checkpoint_path=path, checkpoint_every=2)
    snap = C.load_snapshot(path, device="cpu")
    assert snap.epoch == 4 and snap.k_block == k and not snap.warm_up
    got = tcore.fit(cfg, tcore.init_state(9, cfg, device="cpu"), y, seed=11, max_iter=6,
                    epochs_per_dispatch=k, resume_from=path)
    assert (got.epochs_run, got.warm_up, got.lr, got.loss) == (ref.epochs_run, ref.warm_up,
                                                               ref.lr, ref.loss)
    assert torch.equal(got.mu, ref.mu) and torch.equal(got.logvar, ref.logvar)
    if select == "forecast":
        assert got.selected_epoch is not None
        assert (got.selected_epoch, got.selected_metric) == (ref.selected_epoch,
                                                             ref.selected_metric)
    _assert_same(ref.state, got.state)


def test_fit_resume_at_max_iter_returns_the_snapshot(tmp_path):
    cfg = _cfg()
    y = _data()
    path = str(tmp_path / "fit.ckpt")
    ref = tcore.fit(cfg, tcore.init_state(0, cfg, device="cpu"), y, seed=3, max_iter=4,
                    checkpoint_path=path, checkpoint_every=2)
    got = tcore.fit(cfg, tcore.init_state(0, cfg, device="cpu"), y, seed=3, max_iter=4,
                    resume_from=path)
    assert got.epochs_run == 4 and got.loss == ref.loss and torch.equal(got.mu, ref.mu)
    _assert_same(ref.state, got.state)


def test_fit_resume_validation(tmp_path):
    cfg = _cfg()
    y = _data()
    path = str(tmp_path / "fit.ckpt")
    state = tcore.init_state(0, cfg, device="cpu")
    tcore.fit(cfg, state, y, seed=3, max_iter=2, checkpoint_path=path, checkpoint_every=1)
    with pytest.raises(ValueError, match="mutually exclusive"):
        tcore.fit(cfg, state, y, seed=3, max_iter=3, resume_from=path,
                  noise_hook=lambda e: None)
    with pytest.raises(ValueError, match="different config"):
        tcore.fit(cfg.replace(lr=3e-2), state, y, seed=3, max_iter=3, resume_from=path)
    with pytest.raises(ValueError, match="epochs_per_dispatch=1"):
        tcore.fit(cfg, state, y, seed=3, max_iter=3, resume_from=path, epochs_per_dispatch=2)
    stream = str(tmp_path / "stream.ckpt")
    snap = tcore._make_stream_snapshot(cfg, 1, state, torch.Generator(), 1e-3, None, False,
                                       False, False, True, None, 1)
    C.save_snapshot(stream, snap)
    with pytest.raises(ValueError, match="not a fit snapshot"):
        tcore.fit(cfg, state, y, seed=3, max_iter=3, resume_from=stream)


# ---------------------------------------------------------------------------
# the streaming loader and device_prefetch
# ---------------------------------------------------------------------------


@pytest.fixture
def stream_file(tmp_path):
    data = np.arange(10 * 2 * 3, dtype=np.float32).reshape(10, 2, 3)
    path = str(tmp_path / "stream.bin")
    data.tofile(path)
    return path, data


@pytest.mark.parametrize("native", [True, False])
def test_streaming_loader_round_trip(stream_file, native):
    """Fixed-shape chunks, the final one zero-padded with its true length in
    ``last_valid``, by the native reader and by the Python one."""
    path, data = stream_file
    loader = StreamingLoader(path, ydim=3, batch=2, chunk=4, native=native)
    assert loader.is_native is native
    chunks, valid = [], []
    for c in loader:
        chunks.append(c)
        valid.append(loader.last_valid)
    assert valid == [4, 4, 2] and all(c.shape == (4, 2, 3) for c in chunks)
    np.testing.assert_array_equal(np.concatenate(chunks)[:10], data)
    assert not chunks[-1][2:].any()
    assert chunks[0] is not chunks[1] and not loader.is_native
    loader.close()


def test_streaming_loader_uint8(tmp_path):
    counts = np.random.default_rng(1).integers(0, 255, size=(9, 2, 4), dtype=np.uint8)
    path = str(tmp_path / "counts.bin")
    counts.tofile(path)
    got = list(StreamingLoader(path, ydim=4, batch=2, chunk=3, dtype=np.uint8))
    assert all(c.dtype == np.uint8 for c in got)
    np.testing.assert_array_equal(np.concatenate(got), counts)


def test_native_fifo_ends_and_closes_without_hanging(tmp_path):
    """close() on an idle FIFO returns; a writer that attaches later is read,
    and its leaving ends the stream (a torn half step is dropped)."""
    idle = str(tmp_path / "idle.fifo")
    os.mkfifo(idle)
    loader = StreamingLoader(idle, ydim=4, batch=1, chunk=8, native=True)
    done = threading.Event()
    threading.Thread(target=lambda: (loader.close(), done.set()), daemon=True).start()
    assert done.wait(timeout=10.0), "close() hung on an idle FIFO"

    fifo = str(tmp_path / "late.fifo")
    os.mkfifo(fifo)
    loader = StreamingLoader(fifo, ydim=4, batch=1, chunk=8, native=True)
    data = np.arange(3 * 4 + 2, dtype=np.float32)   # three steps and half of one

    def writer():
        time.sleep(0.2)
        with open(fifo, "wb") as f:
            f.write(data.tobytes())

    out, finished = [], threading.Event()

    def consume():
        out.extend(c.copy() for c in loader)
        finished.set()

    threads = [threading.Thread(target=f, daemon=True) for f in (writer, consume)]
    for t in threads:
        t.start()
    try:
        assert finished.wait(timeout=15.0), "EOF never reached after the writer left"
        assert len(out) == 1 and loader.last_valid == 3
        np.testing.assert_array_equal(out[0][:3].reshape(-1), data[:12])
    finally:
        # nothing of this test outlives it: the loader closed, the threads
        # joined with a bound
        loader.close()
        for t in threads:
            t.join(timeout=5.0)


def test_native_build_failure_is_cached(tmp_path, monkeypatch, caplog, stream_file):
    """A failed build is recorded beside the would-be library: a later
    process does not run the compiler again, and the loader reads with
    Python, saying so in the log."""
    monkeypatch.setattr(L, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(L, "_lib", None)
    monkeypatch.setattr(L, "_lib_tried", False)
    calls = []

    def no_compiler(*a, **k):
        calls.append(a)
        raise OSError("no compiler")

    monkeypatch.setattr(L.subprocess, "run", no_compiler)
    with caplog.at_level(logging.WARNING, logger=L.__name__):
        assert L._load_native() is None
    assert len(calls) == 1 and "Python reader" in caplog.text
    assert list((tmp_path / "build").glob("stream-*/build_failed"))
    monkeypatch.setattr(L, "_lib_tried", False)      # a new process
    assert L._load_native() is None and len(calls) == 1
    monkeypatch.setattr(L, "_lib_tried", False)
    path, data = stream_file
    loader = StreamingLoader(path, ydim=3, batch=2, chunk=5)
    assert not loader.is_native and len(calls) == 1
    np.testing.assert_array_equal(np.concatenate(list(loader)), data)
    with pytest.raises(RuntimeError, match="unavailable"):
        StreamingLoader(path, ydim=3, batch=2, chunk=5, native=True)


def test_device_prefetch_yields_valid_pairs(stream_file):
    """With ``valid_fn`` each chunk comes with its own count, sampled when
    it was drawn (a consumer-side read would see the tail's)."""
    path, data = stream_file
    loader = StreamingLoader(path, ydim=3, batch=2, chunk=4)
    got = list(device_prefetch(loader, depth=3, valid_fn=lambda: loader.last_valid,
                               device="cpu"))
    assert [v for _, v in got] == [4, 4, 2]
    assert all(isinstance(c, torch.Tensor) and c.shape == (4, 2, 3) for c, _ in got)
    np.testing.assert_array_equal(torch.cat([c for c, _ in got])[:10].numpy(), data)
    src = [np.zeros((2, 1, 3), np.float32)]
    out = list(device_prefetch(iter(src), device="cpu"))
    src[0][:] = 1.0
    assert not out[0].any(), "the staged chunk shares the producer's buffer"


def test_device_prefetch_raises_producer_errors():
    def chunks():
        yield np.ones((4, 1, 3), np.float32)
        raise OSError("disk pulled mid-stream")

    got = []
    with pytest.raises(OSError, match="disk pulled"):
        for c in device_prefetch(chunks(), device="cpu"):
            got.append(c)
    assert len(got) == 1

    def boom():
        raise RuntimeError("valid_fn failed")

    with pytest.raises(RuntimeError, match="valid_fn failed"):
        list(device_prefetch(iter([np.zeros((2, 1, 3), np.float32)]), valid_fn=boom,
                             device="cpu"))


def test_device_prefetch_stops_when_abandoned():
    before = threading.active_count()

    def chunks():
        while True:
            yield np.zeros((4, 1, 3), np.float32)

    gen = device_prefetch(chunks(), depth=2, device="cpu")
    next(gen)
    gen.close()
    deadline = time.time() + 5.0
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before, "prefetch worker leaked"


def test_device_prefetch_defaults_to_the_card():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(device_prefetch(iter([np.zeros((2, 1, 3), np.float32)])))


@pytest.mark.card
def test_device_prefetch_on_the_card():
    """Pinned staging on a side stream: the chunks arrive on the card with
    the source's values and dtype, in order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    src = [np.full((64, 16, 200), i, dtype=np.uint8) for i in range(6)]
    got = list(device_prefetch(iter(src), depth=3, valid_fn=lambda: 64))
    assert [v for _, v in got] == [64] * 6
    for i, (c, _) in enumerate(got):
        assert c.is_cuda and c.dtype == torch.uint8 and bool((c == i).all())


# ---------------------------------------------------------------------------
# metrics and debugging
# ---------------------------------------------------------------------------


def _epoch():
    cfg = _cfg(dtype="float64", fused_step="off")
    state = tcore.init_state(0, cfg, device="cpu")
    ys = torch.tensor(_data(t=5), dtype=torch.float64)
    return tcore.run_epoch(cfg, StepFlags(), state, ys, torch.zeros(5, B, 0, dtype=ys.dtype),
                           0, 1e-3)


def test_metrics_writer_and_progress(tmp_path, capsys):
    out = _epoch()
    path = str(tmp_path / "metrics.jsonl")
    writer = MetricsWriter(path)
    seen = []
    cb = multiplex(writer, progress_callback(verbose=False), lambda e, l, r: seen.append(e))
    cb(0, 1.25, out)
    cb(1, 1.10, out)
    lines = [json.loads(line) for line in open(path)]
    assert [r["epoch"] for r in lines] == [0, 1] and lines[1]["loss"] == pytest.approx(1.10)
    assert all(np.isfinite(r[k]) for r in lines for k in ("recon", "dynamics", "entropy"))
    assert seen == [0, 1] and capsys.readouterr().out == ""
    progress_callback(verbose=True, total=3)(2, 0.5, out)     # tqdm's bar or a line


def test_step_timer_and_profiler_trace(tmp_path):
    t = StepTimer()
    t.start()
    t.tick(100, sync_scalar=torch.tensor(1.0))
    assert t.steps == 100 and t.steps_per_sec > 0
    with profiler_trace(str(tmp_path / "trace")):
        torch.ones(8) @ torch.ones(8)
    assert (tmp_path / "trace" / "trace.json").exists()
    with profiler_trace(None):
        pass


def test_finite_checks_and_nan_debugging(capsys):
    state = tcore.init_state(0, _cfg(), device="cpu")
    assert_all_finite(state, "state")
    bad = state._replace(lik_n_sample=torch.tensor(float("nan")))
    with pytest.raises(FloatingPointError, match="lik_n_sample"):
        assert_all_finite(bad, "state")
    with pytest.raises(FloatingPointError, match="weight"):
        lin = state.params.decoder
        broken = tcore.linear_from(torch.full_like(lin.weight, float("inf")), lin.bias)
        assert_all_finite(state.params._replace(decoder=broken))
    assert debug_finite_callback(state) is True
    assert debug_finite_callback(bad, "bad") is False
    assert "non-finite values detected in bad" in capsys.readouterr().out
    enable_nan_debugging(True)
    try:
        assert torch.is_anomaly_enabled()
    finally:
        enable_nan_debugging(False)
    assert not torch.is_anomaly_enabled()
