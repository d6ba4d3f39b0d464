"""Each per-layer metric's reader on a synthetic trace: two epochs, each a
prefix of two steps (kernel and fallback) and one mega launch of eight
steps, the host running ahead of the device."""
import json
from types import SimpleNamespace

import pytest

from bench_tiny import BENCH

import cells
import counts
import tracing

MODEL = json.loads((BENCH / "configs" / "flagship.json").read_text())["model"]
K = "void vjf_kernel<false, false>(VJFArgs)"


def kernel(ts, dur, span, name=K):
    return {"name": name, "ts": ts, "dur": dur, "span": span}


def trace(prefix=True):
    spans, kernels = [], []
    for e, t0 in enumerate((0.0, 2000.0)):
        spans.append(("run_epoch", t0, 900.0))
        t = t0 + 50.0
        if prefix:
            for i in range(2):
                spans.append(("prefix.fused_step_call", t, 40.0))
                kernels.append(kernel(t + 30.0, 70.0, "prefix.fused_step_call"))
                spans.append(("prefix.exact_v_fallback", t + 40.0, 60.0))
                kernels.append(kernel(t + 110.0, 20.0, "prefix.exact_v_fallback", "getrf"))
                t += 100.0
        spans.append(("mega_epoch_call", t, 30.0))
        kernels.append(kernel(t + 400.0, 800.0, "mega_epoch_call"))
    return SimpleNamespace(kernels=kernels, spans=sorted(spans, key=lambda s: s[1]),
                           window=(0.0, 4000.0))


def ctx(tr, prefix=2):
    return SimpleNamespace(trace=tr, model=MODEL, traffic={}, trials=256, steps=10,
                           prefix=prefix)


def read(metric, c):
    return cells.reader(metric)(c)


def test_driver_and_prefix_ms():
    c = ctx(trace())
    # an epoch: 900 us, of it 2 x (40 + 60) + 30 in the port's calls
    assert read("driver_ms.train", c) == pytest.approx((900 - 230) / 1e3)
    assert read("prefix_ms.train", c) == pytest.approx(200 / 1e3)
    assert read("prefix_ms.train", ctx(trace(False), 0)) is None


def test_rooflines():
    c = ctx(trace())
    mega = counts.least_seconds(MODEL, 256, True, 8)[0]
    assert read("mega_roofline.train", c) == pytest.approx(100 * mega / (1600e-6 / 16))
    step = counts.least_seconds(MODEL, 256, False, 1)[0]
    assert read("step_roofline.train", c) == pytest.approx(100 * step / (280e-6 / 4))
    assert read("step_roofline.train", ctx(trace(False), 0)) is None


def test_mfu_and_idle():
    c = ctx(trace())
    need = (4 * counts.step_peak_seconds(MODEL, 256, False)
            + 16 * counts.step_peak_seconds(MODEL, 256, True))
    assert read("mfu_pct.train", c) == pytest.approx(100 * need / 4000e-6)
    busy = 2 * (70 + 20 + 70 + 20 + 800)         # no overlaps in this trace
    assert read("device_idle_pct.train", c) == pytest.approx(100 * (1 - busy / 4000))
    none = ctx(SimpleNamespace(kernels=[], spans=[], window=(0.0, 1.0)))
    assert read("device_idle_pct.prefix_free", none) is None
    assert read("mfu_pct.prefix_free", none) is None
    assert read("mega_roofline.prefix_free", none) is None
    assert read("driver_ms.prefix_free", none) is None


def test_breakdown_and_busy():
    tr = trace()
    iv = tracing.busy_intervals(tr.kernels + [kernel(5.0, 30.0, None)], tr.window)
    assert iv[0] == (5.0, 35.0) and all(a[1] <= b[0] for a, b in zip(iv, iv[1:]))
    bd = tracing.breakdown(tr)
    assert bd["device_ops"][0] == [K, pytest.approx(2 * (140 + 800) * 1e-6)]
    assert len(bd["idle_gaps"]) <= 10
    assert all(g[1] > 0 for g in bd["idle_gaps"])


def test_read_chrome_trace(tmp_path):
    """A kernel is matched to the span whose host code launched it through
    the CUDA correlation id, though it ran after the span ended."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": tracing.WINDOW, "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "prefix.fused_step_call", "ts": 2,
         "dur": 5},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernelExC", "ts": 3, "dur": 1,
         "args": {"correlation": 6}},
        {"ph": "X", "cat": "kernel", "name": K, "ts": 20, "dur": 5, "args": {"correlation": 6}},
        {"ph": "X", "cat": "user_annotation", "name": "mega_epoch_call", "ts": 10, "dur": 5},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernelExC", "ts": 12, "dur": 1,
         "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": K, "ts": 40, "dur": 50, "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "other", "ts": 95, "dur": 2,
         "args": {"correlation": 8}},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    tr = tracing.read(str(path))
    assert tr.window == (0.0, 100.0)
    assert [k["span"] for k in tr.kernels] == ["prefix.fused_step_call", "mega_epoch_call", None]
