"""The yardstick's operation and byte counts against a count by hand."""
import bench_tiny  # noqa: F401  (puts the benchmark on sys.path)
import counts


def test_step_ops_by_hand():
    # xdim 2, ydim 3, hidden (4,), 5 features (8 padded -> 128), B 2
    m = dict(xdim=2, ydim=3, hidden_sizes=[4], n_rbf=5, n_inducing=7, dynamics="rbf")
    b, nfp = 2, 128
    first = 4 * (3 + 2 * 2)                       # the first layer's weight: 28
    fwd = b * (nfp * nfp + nfp * 2 + first + 0 + 2 * 2 * 4 + 3 * 2)
    bwd = b * (2 * 2 * 3 + 4 * 2 * 4 + 0 + first)
    stats = b * nfp * (nfp + 2) + b * nfp * 2
    # below 64 trials a segment step takes 2 base Newton-Schulz iterations
    f32_segment = b * nfp * 2 + 2 * nfp * nfp * 2 + 2 * 2 * nfp ** 3
    assert counts.step_ops(m, b, True) == (2 * f32_segment, 2 * (fwd + bwd + stats))
    f32_prefix = f32_segment + 2 * nfp ** 3       # a prefix step's 3 iterations
    assert counts.step_ops(m, b, False)[0] == 2 * f32_prefix
    # below 64 trials the segment takes 2 base iterations
    assert counts.ns_iters(m, 63, True) == 2 and counts.ns_iters(m, 64, True) == 1


def test_sgp_whitening_is_f32():
    rbf = dict(xdim=2, ydim=3, hidden_sizes=[4], n_rbf=50, n_inducing=50, dynamics="rbf")
    sgp = dict(rbf, dynamics="sgp")
    assert counts.step_ops(sgp, 8, True)[0] - counts.step_ops(rbf, 8, True)[0] == 2 * 8 * 128 ** 2
    assert counts.carry_bytes(sgp) - counts.carry_bytes(rbf) == 4 * 128 ** 2


def test_bytes_and_bound():
    m = dict(xdim=2, ydim=3, hidden_sizes=[4], n_rbf=5, n_inducing=7, dynamics="rbf")
    per_step = 4 * (2 * 3 + 2 * 2 * 2 + 8)
    assert counts.step_bytes(m, 2, 10) == per_step + 2 * counts.carry_bytes(m) / 10
    t, by = counts.least_seconds(m, 2, True, 10)
    f32, mm = counts.step_ops(m, 2, True)
    assert by == "operations" and t == f32 / counts.PEAK_F32 + mm / counts.PEAK_BF16
    # the bound is the larger of the two times
    t_bytes = counts.step_bytes(m, 2, 1) / counts.PEAK_BYTES
    t_ops = counts.step_peak_seconds(m, 2, False)
    assert counts.least_seconds(m, 2, False, 1) == (max(t_ops, t_bytes), "operations")
    assert t_bytes < t_ops
