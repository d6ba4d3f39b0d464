"""The data generators are the yardstick's: the same seed gives the same
data, another seed other data."""
import json

import pytest
import torch

from bench_tiny import BENCH

import gen


@pytest.mark.parametrize("traffic", ["prefix_free", "train_b1024"])
def test_deterministic_by_seed(traffic):
    tr = dict(json.loads((BENCH / "traffic" / f"{traffic}.json").read_text()),
              trials=8, steps=50)
    a = gen.make(tr, 20, 2**33 + 5, "cpu")
    b = gen.make(tr, 20, 2**33 + 5, "cpu")
    c = gen.make(tr, 20, 2**33 + 6, "cpu")
    assert a.shape == (50, 8, 20) and a.dtype == torch.float32
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.isfinite(a).all()


def test_spike_rates():
    tr = {"data": "spikes", "spike_rates": [0.07, 0.05], "trials": 64, "steps": 200}
    y = gen.make(tr, 200, 11, "cpu")
    assert set(torch.unique(y).tolist()) <= {0.0, 1.0, 2.0}
    assert abs(float(y.mean()) - 0.12) < 0.005
