"""The plain reference of one VJF filter-then-learn epoch, in PyTorch.

A frozen copy of the step's plain math (the forward pass, the hand-written
backward, clipped SGD, the observation-noise update, RLS with Newton-Schulz
tracking of the inverse precision, the state-noise update), of the epoch's
layout (the prefix of per-step updates with the exact-inverse fallback, then
the segment with batch-adaptive Newton-Schulz, its escalation and its skip
ceiling), of the in-kernel Philox4x32-10 / Box-Muller noise and of the
model's initialisation from a seed. It imports nothing of the program: it
takes a state as a plain dict of tensors, the benchmark's configuration
dict and the benchmark's data.

Scope: one model, no control inputs, no trial or channel masks (the cells
use none). Products of activations, gradients and statistics round their
inputs to ``mm`` ('bfloat16', or 'fp8' for the control: e4m3 with one scale
per operand) and accumulate in f32; the feedback chain, the RBF cross term
and the sparse-GP whitening stay full f32. The caller turns TF32 off.
"""
from __future__ import annotations

import math

import torch

NS_ITERS = 3            # Newton-Schulz iterations of a prefix step
NS_TAU_THRESHOLD = 0.25  # the exact-inverse fallback and +2 iterations from here
NS_TAU_MAX = 0.7        # a segment step at or above skips its RLS update
NS_EXTRA_ITERS = 2
NS_TAU_ESCALATE = 0.05  # +1 iteration from here
NS_ONE_ITER_MIN_BATCH = 64
FP8_MAX = 448.0         # the largest finite float8_e4m3fn



def matmul_fn(mm: str):
    """``a @ b`` with both inputs rounded to ``mm`` and f32 accumulation."""
    if mm == "float32":
        return torch.matmul
    if mm == "bfloat16":
        return lambda a, b: a.bfloat16().float() @ b.bfloat16().float()
    if mm == "fp8":
        def q8(a):
            s = torch.clamp(a.abs().amax(), min=1e-30) / FP8_MAX
            return (a / s).to(torch.float8_e4m3fn).float() * s
        return lambda a, b: q8(a) @ q8(b)
    raise ValueError(f"unknown product precision {mm!r}")


# ---------------------------------------------------------------------------
# Initialisation from a seed, padding
# ---------------------------------------------------------------------------


def _uniform(gen, shape, lo, hi, device):
    return (lo + (hi - lo) * torch.rand(shape, generator=gen, dtype=torch.float32)).to(device)


def _linear(gen, n_in, n_out, bias, device):
    k = 1.0 / math.sqrt(n_in)
    w = _uniform(gen, (n_out, n_in), -k, k, device)
    return w, (_uniform(gen, (n_out,), -k, k, device) if bias else None)


def init_state(cfg: dict, seed: int, device) -> dict:
    """The model as the configuration initialises it from ``seed``: the
    recognition MLP, the decoder and the dynamics' basis drawn in that
    order from one CPU generator, uniform as torch's ``nn.Linear``."""
    gen = torch.Generator().manual_seed(int(seed))
    xd, yd, hid = cfg["xdim"], cfg["ydim"], list(cfg["hidden_sizes"])
    sizes = [yd + 2 * xd] + hid
    st = {"w_layers": [], "b_layers": []}
    for i in range(len(hid)):
        w, b = _linear(gen, sizes[i], sizes[i + 1], True, device)
        st["w_layers"].append(w)
        st["b_layers"].append(b)
    st["w_mean"], _ = _linear(gen, sizes[-1], xd, False, device)
    st["w_logvar"], st["b_logvar"] = _linear(gen, sizes[-1], xd, True, device)
    st["w_dec"], st["b_dec"] = _linear(gen, xd, yd, True, device)
    r = cfg["centroid_init_range"]
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)  # noqa: E731
    if cfg["dynamics"] == "sgp":
        m = cfg["n_inducing"]
        ind = _uniform(gen, (m, xd), -r, r, device)
        d2 = torch.clamp(torch.sum(ind * ind, -1, keepdim=True) + torch.sum(ind * ind, -1)
                         - 2.0 * (ind @ ind.T), min=0.0)
        kzz = cfg["sgp_scale"] ** 2 * torch.exp(-0.5 * d2 / cfg["sgp_lengthscale"] ** 2)
        lam, u = torch.linalg.eigh(kzz + 1e-5 * torch.eye(m, device=device))
        lam_f = torch.maximum(lam, 1e-4 * torch.clamp(lam[-1], min=1e-30))
        st.update(centroid=ind, whiten=(u * lam_f ** -0.5) @ u.T,
                  log_scale=torch.log(torch.tensor(cfg["sgp_scale"], device=device)),
                  log_lengthscale=torch.log(torch.tensor(cfg["sgp_lengthscale"],
                                                         device=device)))
        nf = m
    else:
        nf = cfg["n_rbf"]
        st.update(centroid=_uniform(gen, (nf, xd), -r, r, device), logwidth=z(nf))
    st.update(w_dyn=z(nf, xd), precision=torch.eye(nf, device=device),
              cov=torch.eye(nf, device=device), state_logvar=z(), dyn_n=z(),
              lik_logvar=(torch.tensor(cfg["init_obs_logvar"], device=device)
                          if cfg["likelihood"] == "gaussian" else z()),
              lik_n=z())
    return st


def n_padded(nf: int) -> int:
    return ((nf + 127) // 128) * 128


def pad(cfg: dict, st: dict) -> dict:
    """The state as one epoch carries it: features padded to a multiple of
    128 (pad centroids far away, so pad features are exactly 0; identity pad
    blocks in P and V; zero pad rows of w), the first layer's weight split
    by input block, every leaf a fresh f32 tensor."""
    xd, yd = cfg["xdim"], cfg["ydim"]
    dev = st["w_dyn"].device
    nf = st["w_dyn"].shape[0]
    nfp = n_padded(nf)
    f = lambda t: t.detach().to(torch.float32).clone()  # noqa: E731
    cent = torch.full((nfp, xd), 1e6, device=dev)
    cent[:nf] = st["centroid"]
    c = {"cent_x": cent, "c2": torch.sum(cent * cent, -1).reshape(1, nfp), "nf": nf}
    if cfg["dynamics"] == "sgp":
        c["inv_w2"] = torch.exp(-2.0 * st["log_lengthscale"]).expand(1, nfp).float().clone()
        c["scale2"] = torch.exp(2.0 * st["log_scale"]).float().reshape(())
        c["w_white"] = torch.zeros((nfp, nfp), device=dev)
        c["w_white"][:nf, :nf] = c["scale2"] * st["whiten"]
    else:
        c["inv_w2"] = torch.ones((1, nfp), device=dev)
        c["inv_w2"][0, :nf] = torch.exp(-2.0 * st["logwidth"])
        c["w_white"] = c["scale2"] = None
    pad_eye = torch.eye(nfp, device=dev)
    pad_eye[:nf, :nf] = 0.0
    for k in ("precision", "cov"):
        m = torch.zeros((nfp, nfp), device=dev)
        m[:nf, :nf] = st[k]
        c[k] = m + pad_eye
    c["w_dyn"] = torch.zeros((nfp, xd), device=dev)
    c["w_dyn"][:nf] = st["w_dyn"]
    w0 = st["w_layers"][0]
    c.update(w_in_y=f(w0[:, :yd]), w_in_m=f(w0[:, yd:yd + xd]), w_in_lv=f(w0[:, yd + xd:]),
             w_hidden=[f(w) for w in st["w_layers"][1:]], b_hidden=[f(b) for b in st["b_layers"]],
             w_mean=f(st["w_mean"]), w_logvar=f(st["w_logvar"]), b_logvar=f(st["b_logvar"]),
             w_dec=f(st["w_dec"]), b_dec=f(st["b_dec"]))
    for k in ("state_logvar", "dyn_n", "lik_logvar", "lik_n"):
        c[k] = f(st[k]).reshape(())
    return c


def rls_leaves(c: dict) -> dict:
    """The dynamics' weight posterior and state noise of a carry, unpadded."""
    nf = c["nf"]
    return {"w_dyn": c["w_dyn"][:nf], "precision": c["precision"][:nf, :nf],
            "cov": c["cov"][:nf, :nf], "state_logvar": c["state_logvar"],
            "dyn_n": c["dyn_n"]}


# ---------------------------------------------------------------------------
# Noise
# ---------------------------------------------------------------------------

_M0, _M1, _W0, _W1, _MASK = 0xD2511F53, 0xCD9E8D57, 0x9E3779B9, 0xBB67AE85, 0xFFFFFFFF


def _mulhilo(a: int, b: torch.Tensor):
    t1 = (a & 0xFFFF) * b
    t2 = (a >> 16) * b
    lo = (((t2 & 0xFFFF) << 16) + t1) & _MASK
    hi = (t2 + (t1 >> 16)) >> 16
    return hi, lo


def philox(ctr, key):
    """Philox4x32-10 (Random123's constants) on int64 tensors of uint32 words."""
    c0, c1, c2, c3 = (c & _MASK for c in ctr)
    k0, k1 = (k & _MASK for k in key)
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def step_noise(seed: int, steps, b: int, xd: int, device):
    """``(eps_s, eps_t)``, each (len(steps), B, xd): the standard normals of
    those steps of an epoch keyed by ``seed``. Element i of step t's
    row-major (B, 2 xd) draw takes counter (t, i // 2, 0, 0) and key (seed,
    0), words 2 (i % 2) and 2 (i % 2) + 1 as its two uniforms (top 24
    bits), then Box-Muller; the first xd columns are eps_s."""
    n = b * 2 * xd
    t = torch.as_tensor(list(steps), dtype=torch.int64, device=device)[:, None]
    i = torch.arange(n, dtype=torch.int64, device=device)[None, :]
    zero = torch.zeros((), dtype=torch.int64, device=device)
    seed_t = torch.full((), int(seed), dtype=torch.int64, device=device)
    w = philox((t, i // 2, zero, zero), (seed_t, zero))
    odd = (i % 2) == 1
    u1 = (torch.where(odd, w[2], w[0]) >> 8).float() * 2.0 ** -24 + 2.0 ** -25
    u2 = (torch.where(odd, w[3], w[1]) >> 8).float() * 2.0 ** -24
    eps = (torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * 3.14159265358979) * u2))
    eps = eps.reshape(-1, b, 2 * xd)
    return eps[..., :xd], eps[..., xd:]


# ---------------------------------------------------------------------------
# One step
# ---------------------------------------------------------------------------


def features(c: dict, xs: torch.Tensor) -> torch.Tensor:
    """The dynamics' basis at the sampled previous latent, full f32; with a
    sparse GP whitened against the inducing points."""
    x2 = torch.sum(xs * xs, dim=-1, keepdim=True)
    d2 = torch.clamp(x2 + c["c2"] - 2.0 * (xs @ c["cent_x"].T), min=0.0)
    feat = torch.exp(-0.5 * d2 * c["inv_w2"])
    return feat if c["w_white"] is None else feat @ c["w_white"]


def _ns(x, p, eye2):
    return x @ (eye2 - p @ x)


def rls_update(cfg: dict, c: dict, feat, dx, fvf_sum, mm, segment: bool):
    """RLS with Newton-Schulz tracking from the step's statistics: returns
    ``(leaves, tau, g)``. ``segment``: the mega segment's batch-adaptive
    base iterations, escalation and skip ceiling; else a prefix step's fixed
    iterations, P always advancing."""
    b, xd = dx.shape
    slv = c["state_logvar"]
    lam, jit = float(cfg["rls_shrink"]), float(cfg["chol_jitter"])
    p, v, w = c["precision"], c["cov"], c["w_dyn"]
    nfp = p.shape[0]
    dev = p.device
    inv_sv = torch.exp(-slv)
    dyn_ok = torch.isfinite(torch.sum(dx))
    g = lam * (p @ w) + mm(feat.T, dx) * inv_sv
    p_new = lam * p + mm(feat.T, feat) * inv_sv
    if lam != 1.0 or jit != 0.0:
        eye = torch.eye(nfp, device=dev)
        pad_diag = eye * (torch.arange(nfp, device=dev)[:, None] >= c["nf"]).float()
        p_new = p_new + (1.0 - lam) * pad_diag + jit * (eye - pad_diag)
    tau = fvf_sum * inv_sv / lam
    x = v / lam if lam != 1.0 else v
    eye2 = 2.0 * torch.eye(nfp, device=dev)
    if segment:
        base = int(cfg["mega_ns_iters"]) or (1 if b >= NS_ONE_ITER_MIN_BATCH else 2)
        for _ in range(base):
            x = _ns(x, p_new, eye2)
        x = torch.where(tau >= NS_TAU_ESCALATE, _ns(x, p_new, eye2), x)
        x2 = x
        for _ in range(NS_EXTRA_ITERS):
            x2 = _ns(x2, p_new, eye2)
        x = torch.where(tau >= NS_TAU_THRESHOLD, x2, x)
    else:
        for _ in range(NS_ITERS):
            x = _ns(x, p_new, eye2)
    v_new = 0.5 * (x + x.T)
    w_new = v_new @ g
    ns_ok = torch.isfinite(torch.sum(v_new) + torch.sum(w_new))
    if segment:
        ns_ok = ns_ok & (tau < NS_TAU_MAX)
    upd_ok = dyn_ok & ns_ok
    w_new = torch.where(upd_ok, w_new, w)
    out = {"precision": torch.where(upd_ok if segment else dyn_ok, p_new, p),
           "cov": torch.where(upd_ok, v_new, v), "w_dyn": w_new}
    inf = torch.full((), float("inf"), device=dev)
    tau = torch.where(dyn_ok, torch.where(ns_ok, tau, inf), torch.zeros((), device=dev))
    return out, tau, g


def state_noise(cfg: dict, slv, dyn_n, mse, b: int):
    """The state noise's running variance after ``b`` residuals of mean
    square ``mse``: ``(state_logvar, dyn_n, ok)``, the new values where the
    variance is finite (``ok``), else the old."""
    n = torch.clamp(dyn_n, max=float(cfg["state_var_cap"]))
    tot = n + b
    var = (n / tot) * torch.exp(slv) + (b / tot) * mse
    ok = torch.isfinite(var)
    new = torch.clamp(torch.log(var), -cfg["logvar_clamp"], cfg["logvar_clamp"])
    return torch.where(ok, new, slv), torch.where(ok, tot, dyn_n), ok


def exact_fallback(cfg: dict, c: dict, prev: dict, g, xs, xt, tau):
    """Where the prefix step's tau reached ``NS_TAU_THRESHOLD``: V from the
    exact inverse of the new P (Cholesky, then the triangular inverse by
    Newton iteration), w = V g, and the state noise from the pre-step
    counters; skipped where the factorisation fails or a value is not
    finite."""
    b = xs.shape[0]
    chol, info = torch.linalg.cholesky_ex(c["precision"])
    n = chol.shape[-1]
    eye = torch.eye(n, device=chol.device)
    x = eye * (1.0 / torch.diagonal(chol))[:, None]
    for _ in range(max(1, math.ceil(math.log2(n)))):
        x = x @ (2.0 * eye - chol @ x)
    v_new = x.T @ x
    w_new = v_new @ g
    resid = (xt - xs) - features(c, xs) @ w_new
    slv, dn, var_ok = state_noise(cfg, prev["state_logvar"], prev["dyn_n"],
                                  torch.mean(resid * resid), b)
    ok = (info == 0) & torch.isfinite(torch.sum(v_new) + torch.sum(w_new)) & var_ok
    take = (tau >= NS_TAU_THRESHOLD) & ok
    return {**c, "cov": torch.where(take, v_new, c["cov"]),
            "w_dyn": torch.where(take, w_new, c["w_dyn"]),
            "state_logvar": torch.where(take, slv, c["state_logvar"]),
            "dyn_n": torch.where(take, dn, c["dyn_n"])}


def step(cfg: dict, flags: dict, c: dict, qm, qlv, y, eps_s, eps_t, lr, mm, segment: bool):
    """One filter-then-learn step on a padded carry: ``(carry, qt_mean,
    qt_logvar, loss)``. ``flags``: ``sgd``, ``update``, ``warm_up`` (no
    dynamics term, no RLS). ``segment`` picks the mega segment's
    Newton-Schulz rules; a prefix step (``segment=False``) of an RLS epoch
    ends with :func:`exact_fallback`."""
    b = y.shape[0]
    inv_b = 1.0 / b
    xd = cfg["xdim"]
    slv = c["state_logvar"]
    warm = flags["warm_up"]
    poisson = cfg["likelihood"] == "poisson"
    clamp_lv = cfg["logvar_clamp"]
    # ---- forward ----
    xs = qm + eps_s * torch.exp(0.5 * qlv)
    feat = features(c, xs)
    fvf = torch.clamp(torch.sum(mm(feat, c["cov"]) * feat, dim=-1, keepdim=True), min=1e-30)
    if c["w_white"] is not None:
        dtc = torch.clamp(c["scale2"] - torch.sum(feat * feat, dim=-1, keepdim=True), min=0.0)
        pt_lv = torch.log(fvf + dtc + 1e-30)
    else:
        pt_lv = torch.log(fvf)
    pt_m = (1.0 - cfg["leak"]) * xs + mm(feat, c["w_dyn"])
    a = torch.tanh(mm(y, c["w_in_y"].T) + mm(qm, c["w_in_m"].T) + mm(qlv, c["w_in_lv"].T)
                   + c["b_hidden"][0])
    hs = [a]
    for i, w in enumerate(c["w_hidden"]):
        a = torch.tanh(mm(a, w.T) + c["b_hidden"][i + 1])
        hs.append(a)
    qt_m = mm(a, c["w_mean"].T)
    raw_lv = mm(a, c["w_logvar"].T) + c["b_logvar"]
    qt_lv = torch.clamp(raw_lv, -clamp_lv, clamp_lv)
    sig_t = torch.exp(0.5 * qt_lv)
    xt = qt_m + eps_t * sig_t
    py = mm(xt, c["w_dec"].T) + c["b_dec"]
    # ---- the ELBO's batch sums ----
    if poisson:
        pyc = torch.clamp(py, max=cfg["poisson_clamp"])
        exp_pyc = torch.exp(pyc)
        recon_b = torch.sum(exp_pyc - y * pyc) * inv_b
    else:
        resid_y = y - py
        sq_y = torch.sum(resid_y * resid_y)
    inv_sv = torch.exp(-slv)
    diff = pt_m - qt_m
    if cfg["trace_quirk"]:
        trace = torch.exp(pt_lv + qt_lv - slv)
    else:
        trace = torch.exp(pt_lv - slv) + torch.exp(qt_lv - slv)
    dyn_b = torch.sum(diff * diff) * inv_sv * inv_b + torch.sum(trace) * inv_b
    h_ent = 0.5 * torch.sum(qt_lv) * inv_b
    # ---- the ELBO ----
    ydim = c["w_dec"].shape[0]
    if poisson:
        l_recon = recon_b
    else:
        lik_lv = c["lik_logvar"]
        l_recon = 0.5 * (sq_y * torch.exp(-lik_lv) * inv_b + ydim * lik_lv)
    l_dyn = 0.5 * (dyn_b + xd * slv)
    raw_ok = torch.isfinite(l_recon) & torch.isfinite(h_ent)
    if not warm:
        raw_ok = raw_ok & torch.isfinite(l_dyn)
    zero = torch.zeros((), device=y.device)
    fin = lambda v: torch.where(torch.isfinite(v), v, zero)  # noqa: E731
    loss = fin(l_recon) - fin(h_ent) + (0.0 if warm else fin(l_dyn))
    new = dict(c)
    # ---- backward and clipped SGD ----
    if flags["sgd"]:
        if poisson:
            g_py = (exp_pyc - y) * (py < cfg["poisson_clamp"]) * inv_b
            g_lik = zero
        else:
            g_py = -resid_y * torch.exp(-c["lik_logvar"]) * inv_b
            g_lik = -0.5 * sq_y * torch.exp(-c["lik_logvar"]) * inv_b
        g_xt = mm(g_py, c["w_dec"])
        g = {"w_dec": mm(g_py.T, xt), "b_dec": torch.sum(g_py, dim=0)}
        g_qm = g_xt
        g_qlv = g_xt * eps_t * (0.5 * sig_t) - 0.5 * inv_b
        if not warm:
            g_qm = g_qm - diff * (inv_sv * inv_b)
            if cfg["trace_quirk"]:
                g_qlv = g_qlv + 0.5 * trace * inv_b
            else:
                g_qlv = g_qlv + 0.5 * torch.exp(qt_lv - slv) * inv_b
        g_qlv = g_qlv * (torch.abs(raw_lv) < clamp_lv)
        g["w_mean"] = mm(g_qm.T, a)
        g["w_logvar"] = mm(g_qlv.T, a)
        g["b_logvar"] = torch.sum(g_qlv, dim=0, keepdim=True)
        g_h = mm(g_qm, c["w_mean"]) + mm(g_qlv, c["w_logvar"])
        nh = len(c["w_hidden"])
        g_wh, g_bh = [None] * nh, [None] * (nh + 1)
        for i in range(nh, 0, -1):
            g_a = g_h * (1.0 - hs[i] * hs[i])
            g_wh[i - 1] = mm(g_a.T, hs[i - 1])
            g_bh[i] = torch.sum(g_a, dim=0, keepdim=True)
            g_h = mm(g_a, c["w_hidden"][i - 1])
        g_a0 = g_h * (1.0 - hs[0] * hs[0])
        g_bh[0] = torch.sum(g_a0, dim=0, keepdim=True)
        g["w_in_y"], g["w_in_m"], g["w_in_lv"] = (mm(g_a0.T, y), mm(g_a0.T, qm),
                                                  mm(g_a0.T, qlv))
        grads = [*g.values(), g_lik, *g_wh, *g_bh]
        ok = raw_ok & torch.isfinite(sum(torch.sum(t) for t in grads))
        clip = cfg["clip"]

        def upd(p, gr):
            return torch.where(ok, p - lr * torch.clamp(gr, -clip, clip), p)

        g["b_dec"] = g["b_dec"].reshape(c["b_dec"].shape)
        for k, gr in g.items():
            new[k] = upd(c[k], gr)
        new["w_hidden"] = [upd(w, gr) for w, gr in zip(c["w_hidden"], g_wh)]
        new["b_hidden"] = [upd(bb, gr.reshape(bb.shape)) for bb, gr in zip(c["b_hidden"], g_bh)]
        if not poisson:
            new["lik_logvar"] = upd(c["lik_logvar"], g_lik + 0.5 * ydim)
    # ---- the observation noise, then the dynamics ----
    if flags["update"] and not poisson:
        n = torch.clamp(new["lik_n"], max=float(cfg["obs_var_cap"]))
        tot = n + b
        var = (n / tot) * torch.exp(new["lik_logvar"]) + (b / tot) * (sq_y * inv_b / ydim)
        ok = torch.isfinite(var)
        new["lik_logvar"] = torch.where(
            ok, torch.clamp(torch.log(var), -clamp_lv, clamp_lv), new["lik_logvar"])
        new["lik_n"] = torch.where(ok, tot, new["lik_n"])
    tau = zero
    if flags["update"]:
        dx = xt - xs
        if not warm:
            rls, tau, g_vec = rls_update(cfg, c, feat, dx, torch.sum(fvf), mm, segment)
            new.update(rls)
        resid = dx - mm(feat, new["w_dyn"])
        new["state_logvar"], new["dyn_n"], _ = state_noise(
            cfg, slv, c["dyn_n"], torch.mean(resid * resid), b)
        if not warm and not segment:
            new = exact_fallback(cfg, new, c, g_vec, xs, xt, tau)
    return new, qt_m, qt_lv, loss


def follow(cfg: dict, flags: dict, st: dict, ys, seed: int, lr: float, prefix: int,
           steps: int, mm: str):
    """The first ``steps`` steps of an epoch over ``ys`` from the state
    ``st``, the posterior starting at the prior (zeros), the first
    ``prefix`` as prefix steps: ``(q (steps, 2, B, xd), loss (steps,),
    carry)``."""
    c = pad(cfg, st)
    mmf = matmul_fn(mm)
    b, xd = ys.shape[1], cfg["xdim"]
    qm = torch.zeros((b, xd), device=ys.device)
    qlv = torch.zeros((b, xd), device=ys.device)
    eps_s, eps_t = step_noise(seed, range(steps), b, xd, ys.device)
    lr_t = torch.full((), float(lr), device=ys.device)
    qs, losses = [], []
    for t in range(steps):
        c, qm, qlv, loss = step(cfg, flags, c, qm, qlv, ys[t], eps_s[t], eps_t[t], lr_t, mmf,
                                segment=t >= prefix)
        qs.append(torch.stack([qm, qlv]))
        losses.append(loss)
    return torch.stack(qs), torch.stack(losses), c


def sgd_leaves(c: dict) -> dict:
    """The weights that SGD trains, by name and flattened: the recognition
    MLP (its first layer by input block), the decoder and the observation
    noise."""
    out = {k: c[k] for k in ("w_in_y", "w_in_m", "w_in_lv", "w_mean", "w_logvar", "b_logvar",
                             "w_dec", "b_dec", "lik_logvar")}
    out.update({f"w_hidden.{i}": w for i, w in enumerate(c["w_hidden"])})
    out.update({f"b_hidden.{i}": b for i, b in enumerate(c["b_hidden"])})
    return {k: v.reshape(-1) for k, v in out.items()}


def _pick(x, i):
    return torch.index_select(x, 0, i.reshape(1)).squeeze(0)


def teacher_forced(cfg: dict, flags: dict, st: dict, ys, q_means, q_logvars, seed: int,
                   lr: float, prefix: int, mm: str, chunk: int = 256, graph: bool = False):
    """Every step of an epoch over ``ys`` from the state ``st``, each fed
    the posterior that the program reported for the step before (the prior
    at step 0; ``q_means``, ``q_logvars``: (T, B, xd)) in place of the
    reference's own, as a served model's reference reads the served tokens.
    The reference carries its own weights, weight posterior and state
    noise through every step, so a step's posterior and the state at the
    end are the reference's answer to the program's inputs alone. Returns
    ``(gap, carry)``: ``gap`` the widest one-step gap of a posterior the
    program reported from the reference's, over the steps and the two
    leaves, |program - reference| / |reference| of the step's (B, xd) block;
    ``carry`` the reference's state at the end.

    ``graph``: the segment's steps (``t >= prefix``) are captured once as
    a CUDA graph and replayed, the same kernels in the same order, so the
    same bits as eager steps at a fraction of their host time."""
    c = pad(cfg, st)
    mmf = matmul_fn(mm)
    t_len, b, xd = q_means.shape
    dev = q_means.device
    lr_t = torch.full((), float(lr), device=dev)
    t_dev = torch.zeros((), dtype=torch.int64, device=dev)
    worst = torch.zeros((), device=dev)
    zeros = torch.zeros((b, xd), device=dev)
    eps = torch.zeros((2, chunk, b, xd), device=dev)

    def body(segment: bool):
        first = t_dev == 0
        prev = (t_dev - 1).clamp(min=0)
        qm = torch.where(first, zeros, _pick(q_means, prev))
        qlv = torch.where(first, zeros, _pick(q_logvars, prev))
        k = torch.remainder(t_dev, chunk)
        new, qt_m, qt_lv, _ = step(cfg, flags, c, qm, qlv, _pick(ys, t_dev),
                                   _pick(eps[0], k), _pick(eps[1], k), lr_t, mmf, segment)
        for got, ref in ((_pick(q_means, t_dev), qt_m), (_pick(q_logvars, t_dev), qt_lv)):
            worst.copy_(torch.maximum(worst, (got - ref).norm() / ref.norm()))
        for key, v in new.items():
            if isinstance(v, list):
                for old, nv in zip(c[key], v):
                    old.copy_(nv)
            elif isinstance(v, torch.Tensor) and v is not c[key]:
                c[key].copy_(v.reshape(c[key].shape))
        t_dev.add_(1)

    captured = None
    for t in range(t_len):
        if t % chunk == 0:
            e_s, e_t = step_noise(seed, range(t, min(t + chunk, t_len)), b, xd, dev)
            eps[0, :e_s.shape[0]].copy_(e_s)
            eps[1, :e_t.shape[0]].copy_(e_t)
        if t < prefix or not graph or t == prefix:
            body(t >= prefix)
            continue
        if captured is None:
            captured = torch.cuda.CUDAGraph()
            with torch.cuda.graph(captured):
                body(True)
        captured.replay()
    return float(worst), c
