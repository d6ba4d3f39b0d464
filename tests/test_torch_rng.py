"""The port's plain Philox4x32-10 + Box-Muller sampler (the reference for the
kernels' device function)."""
import numpy as np
import pytest
import torch

from vjf_tpu_torch.ops import rng

torch.set_num_threads(1)


def _words(ctr, key):
    c = [torch.tensor(v, dtype=torch.int64) for v in ctr]
    k = [torch.tensor(v, dtype=torch.int64) for v in key]
    return [int(w) for w in rng.philox4x32_10(c, k)]


@pytest.mark.parametrize("ctr,key,expected", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
], ids=["zeros", "ones", "pi"])
def test_philox_known_answers(ctr, key, expected):
    """Random123's known-answer vectors for Philox4x32-10."""
    assert tuple(_words(ctr, key)) == expected


def test_negative_int32_seed_is_its_uint32_word():
    """The int32 carry leaves hold uint32 words (the kernel casts the same)."""
    a = rng.uniforms(torch.tensor([[-5]], dtype=torch.int32), torch.tensor([[3]]), 4, 6)
    b = rng.uniforms(torch.tensor(2**32 - 5), torch.tensor(3), 4, 6)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_box_muller_moments():
    eps = rng.normals(torch.tensor(7), torch.tensor(0), 1000, 1000).double().numpy()
    # 1e6 draws: the standard error of the mean is 1e-3, of the variance ~1.4e-3
    assert abs(eps.mean()) < 5e-3
    assert abs(eps.var() - 1.0) < 7e-3
    assert np.isfinite(eps).all()
    u1, u2 = rng.uniforms(torch.tensor(7), torch.tensor(0), 1000, 1000)
    assert float(u1.min()) > 0.0 and float(u1.max()) < 1.0
    assert float(u2.min()) >= 0.0 and float(u2.max()) < 1.0


def test_rng_count_advances_the_stream():
    seed = torch.tensor([[11]], dtype=torch.int32)
    e0 = rng.normals(seed, torch.tensor([[0]], dtype=torch.int32), 8, 6)
    e0b = rng.normals(seed, torch.tensor([[0]], dtype=torch.int32), 8, 6)
    e1 = rng.normals(seed, torch.tensor([[1]], dtype=torch.int32), 8, 6)
    assert torch.equal(e0, e0b)
    assert not torch.isclose(e0, e1).any()
    other = rng.normals(torch.tensor([[12]], dtype=torch.int32),
                        torch.tensor([[0]], dtype=torch.int32), 8, 6)
    assert not torch.isclose(e0, other).any()


def test_latents_split_one_draw_by_columns():
    seed, count = torch.tensor(3), torch.tensor(9)
    eps = rng.normals(seed, count, 5, 8)
    es, et = rng.box_muller_latents(seed, count, 5, 4)
    assert torch.equal(es, eps[:, :4]) and torch.equal(et, eps[:, 4:])
    # element i of the row-major draw: counter (count, i // 2), words by i % 2
    w = _words((9, 3, 0, 0), (3, 0))           # elements 6 and 7 (row 0, cols 6-7)
    u1, u2 = rng.uniforms(seed, count, 5, 8)
    f = np.float32
    assert u1[0, 6].numpy() == f(w[0] >> 8) * f(2.0**-24) + f(2.0**-25)
    assert u2[0, 7].numpy() == f(w[3] >> 8) * f(2.0**-24)
