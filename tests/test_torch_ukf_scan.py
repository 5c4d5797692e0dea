"""PyTorch port: the plain twins of the whole-scan kernels G, H and I
against the JAX kernels (run in interpret mode with ``force_kernel=True``,
as tests/test_ukf_fused.py runs them), float32, with the JAX tests'
bounds: ll within 1e-5 relative, the solution within rtol 2e-4, atol
1e-5; and the routes of every admission branch.  One interpret-mode JAX
call per kernel, at T = 120 (one 128-step block of the JAX kernels)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import np_of

import lowlevelparticlefilters_jl_tpu as llpf
import lowlevelparticlefilters_jl_tpu_torch as llpt
from lowlevelparticlefilters_jl_tpu.ops.pallas import ukf_scan as jk
from lowlevelparticlefilters_jl_tpu_torch import routing
from lowlevelparticlefilters_jl_tpu_torch.kernels import ukf_scan as tk

DT = 0.1
A4 = np.array([[1, 0, DT, 0], [0, 1, 0, DT], [0, 0, 1, 0], [0, 0, 0, 1.0]])
B4 = np.array([[0, 0], [0, 0], [DT, 0], [0, DT]])
C4 = np.array([[1, 0, 0, 0], [0, 1, 0, 0.0]])
R1, R2 = 0.1 * np.eye(4), np.eye(2)
FIELDS = ("x", "xt", "R", "Rt", "e", "S", "K")
F32 = torch.float32


def _j(a):
    return jnp.asarray(a, jnp.float32)


def _t(a):
    return torch.tensor(np.asarray(a), dtype=F32)


def _data(T, nu, seed):
    rng = np.random.default_rng(seed)
    return (0.3 * rng.normal(size=(T, nu)).astype(np.float32),
            rng.normal(size=(T, 2)).astype(np.float32))


def _check(st, sj, rel=1e-5, rtol=2e-4, atol=1e-5):
    assert abs(float(st.ll) - float(sj.ll)) <= rel * abs(float(sj.ll))
    for f in FIELDS:
        np.testing.assert_allclose(np_of(getattr(st, f)),
                                   np_of(getattr(sj, f)), rtol=rtol,
                                   atol=atol, err_msg=f)
    assert bool(st.ok.all())


def _nl_pair(nu):
    """The CV model with inputs and a 0.01 sin(x) term, JAX and torch."""
    (Aj, Bj, Cj), (At, Bt, Ct) = ([f(M) for M in (A4, B4, C4)]
                                  for f in (_j, _t))
    if nu:
        return ((lambda x, u, p, t: Aj @ x + Bj @ u + 0.01 * jnp.sin(x),
                 lambda x, u, p, t: Cj @ x),
                (lambda x, u, p, t: At @ x + Bt @ u + 0.01 * torch.sin(x),
                 lambda x, u, p, t: Ct @ x))
    return ((lambda x, u, p, t: Aj @ x + 0.01 * jnp.sin(x),
             lambda x, u, p, t: Cj @ x),
            (lambda x, u, p, t: At @ x + 0.01 * torch.sin(x),
             lambda x, u, p, t: Ct @ x))


def test_g_twin_matches_jax_kernel():
    (fj, gj), (ft, gt) = _nl_pair(nu=2)
    uj = llpf.make_ukf(fj, gj, _j(R1), _j(R2), ny=2, nu=2, Ts=0.5)
    ut = llpt.make_ukf(ft, gt, _t(R1), _t(R2), ny=2, nu=2, Ts=0.5)
    u, y = _data(120, 2, 0)
    sj = jk.ukf_forward_trajectory_fused(uj, _j(u), _j(y), force_kernel=True)
    st = llpt.ukf_forward_trajectory_fused(ut, _t(u), _t(y),
                                           force_kernel=True)
    assert st.route == llpt.last_route() == "fused_scan_plain"
    _check(st, sj)


def test_i_twin_matches_jax_kernel():
    (fj, gj), (ft, gt) = _nl_pair(nu=0)
    ej = llpf.make_ekf(fj, gj, _j(R1), _j(R2),
                       d0=llpf.MvNormal(jnp.zeros(4), 0.5 * jnp.eye(4)),
                       nu=0, ny=2)
    et = llpt.make_ekf(ft, gt, _t(R1), _t(R2),
                       d0=llpt.MvNormal(torch.zeros(4), 0.5 * torch.eye(4)),
                       nu=0, ny=2)
    _, y = _data(120, 0, 1)
    assert tk._const_affine_kf_params(et, et.measurement_model, 4) is None
    sj = jk.ekf_forward_trajectory_fused(ej, None, _j(y), force_kernel=True)
    st = llpt.ekf_forward_trajectory_fused(et, None, _t(y),
                                           force_kernel=True)
    assert st.route == "fused_scan_plain"
    _check(st, sj)


def _affine_kf(lib, arr):
    A = arr([[0.95, -0.09], [0.09, 0.95]])
    B, C = arr([[0.1], [0.05]]), arr([[1.0, 0.2], [0.0, 1.0]])
    D = arr([[0.03], [0.0]])
    return lib.KalmanFilter(A, B, C, D, 0.01 * arr(np.eye(2)),
                            0.1 * arr(np.eye(2)), alpha=1.01)


def test_h_twin_matches_jax_kernel_and_sequential():
    """Kernel H's twin against the JAX kernel, and, freeze included,
    against the JAX float64 sequential recursion within 1e-4."""
    kj, kt = _affine_kf(llpf, _j), _affine_kf(llpt, _t)
    u, y = _data(120, 1, 2)
    ej, et = kj._fused_delegate(), kt._fused_delegate()
    A, C = tk._const_affine_kf_params(et, et.measurement_model, 2)
    np.testing.assert_array_equal(np_of(A), np_of(kt.A))
    np.testing.assert_array_equal(np_of(C), np_of(kt.C))
    sj = jk.ekf_forward_trajectory_fused(ej, _j(u), _j(y), force_kernel=True)
    st = llpt.ekf_forward_trajectory_fused(et, _t(u), _t(y),
                                           force_kernel=True)
    _check(st, sj)
    k64 = llpf.KalmanFilter(*(jnp.asarray(np_of(M)) for M in (
        kt.A, kt.B, kt.C, kt.D, kt.R1, kt.R2)), alpha=1.01)
    s64 = llpf.forward_trajectory(k64, jnp.asarray(u, jnp.float64),
                                  jnp.asarray(y, jnp.float64),
                                  method="sequential")
    _check(st, s64, rel=1e-4, rtol=1e-4, atol=1e-4)
    ll = kt.loglik_fused(_t(y), _t(u))  # CPU tensors: sequential
    assert llpt.last_route() == "sequential"
    assert abs(float(ll) - float(s64.ll)) < 1e-4 * abs(float(s64.ll))


def test_g_merwe_twin_against_sequential():
    """Merwe weights through kernel G's twin, against the JAX float64
    sequential UKF within the JAX test's 1e-4."""
    (fj, gj), (ft, gt) = _nl_pair(nu=0)
    wp = dict(alpha=0.5, beta=2.0)
    A64, C64 = jnp.asarray(A4), jnp.asarray(C4)
    uj = llpf.make_ukf(lambda x, u, p, t: A64 @ x + 0.01 * jnp.sin(x),
                       lambda x, u, p, t: C64 @ x, jnp.asarray(R1),
                       jnp.asarray(R2), ny=2, nu=0,
                       weight_params=llpf.MerweParams(**wp))
    ut = llpt.make_ukf(ft, gt, _t(R1), _t(R2), ny=2, nu=0,
                       weight_params=llpt.MerweParams(**wp))
    _, y = _data(100, 0, 3)
    llj = float(llpf.loglik(uj, None, jnp.asarray(y, jnp.float64),
                            method="sequential"))
    llt = float(llpt.loglik(ut, None, _t(y), method="fused"))
    assert llpt.last_route() == "fused_scan_plain"
    assert abs(llt - llj) / abs(llj) < 1e-4


def _cv(kind, **kw):
    A, B, C = _t(A4), _t(B4), _t(C4)
    nu = kw.pop("nu", 0)
    f = kw.pop("f", (lambda x, u, p, t: A @ x + B @ u) if nu else
               (lambda x, u, p, t: A @ x))
    g = kw.pop("g", lambda x, u, p, t: C @ x)
    make = llpt.make_ukf if kind == "ukf" else llpt.make_ekf
    if kind == "ekf":
        kw.setdefault("d0", llpt.MvNormal(torch.zeros(4),
                                          0.5 * torch.eye(4)))
    return make(f, g, kw.pop("R1", _t(R1)), _t(R2), ny=2, nu=nu, **kw)


def _kf(**kw):
    return llpt.KalmanFilter(_t(A4), kw.pop("B", None), _t(C4), 0, _t(R1),
                             _t(R2), **kw)


def _route(f, y, method="fused", u=None, verb="loglik"):
    fn = llpt.loglik if verb == "loglik" else llpt.forward_trajectory
    out = fn(f, u, y, method=method)
    return llpt.last_route(verb), out


def test_routes_of_every_admission_branch():
    """``last_route()`` of each admission branch on CPU tensors; the
    out-of-scope cases fall back to the sequential recursion with its
    value (tests/test_ukf_fused.py:73-86, 121-135, 257-270)."""
    _, y = _data(30, 0, 4)
    y = _t(y)
    seq = lambda f, u=None: float(llpt.loglik(  # noqa: E731
        f, u, y, method="sequential"))
    # plain KF: auto on CPU, fused (H's twin), parallel
    kf = _kf()
    assert _route(kf, y, "auto")[0] == "sequential"
    r, ll = _route(kf, y)
    assert r == "fused_scan_plain" and abs(float(ll) - seq(kf)) < 1e-4
    assert _route(kf, y, "parallel")[0] == "temporal_parallel_plain"
    # out of scope: float64, time-stacked A, R12, a p argument
    kf64 = llpt.KalmanFilter(*(torch.tensor(M) for M in (A4, np.zeros(
        (4, 1)), C4)), 0, torch.tensor(R1), torch.tensor(R2))
    assert _route(kf64, y.double())[0] == "sequential"
    A3 = _t(A4)[None].expand(30, 4, 4).contiguous()
    kf3 = llpt.KalmanFilter(A3, None, _t(C4), 0, _t(R1), _t(R2),
                            d0=llpt.MvNormal(torch.zeros(4), torch.eye(4)),
                            nx=4, ny=2)
    assert kf3._fused_delegate() is None
    r, ll = _route(kf3, y)
    assert r == "sequential" and float(ll) == seq(kf3)
    kf12 = _kf(R12=0.01 * torch.ones(4, 2))
    assert _route(kf12, y)[0] == "sequential"
    llpt.loglik(kf, None, y, p=1.0, method="fused")
    assert llpt.last_route() == "sequential"
    # UKF: affine -> H (not G), pinned G, nonlinear G, hooks G
    ukf = _cv("ukf")
    eq = tk._affine_ekf_equivalent(ukf, ukf.measurement_model, 4)
    assert isinstance(eq, llpt.ExtendedKalmanFilter)
    assert _route(ukf, y)[0] == "fused_scan_plain"
    r, ll = _route(ukf, y, "parallel")
    assert r == "temporal_parallel_plain"
    assert abs(float(ll) - seq(ukf)) < 1e-4 * abs(seq(ukf))
    nl = _cv("ukf", f=lambda x, u, p, t: torch.sin(_t(A4) @ x))
    assert tk._affine_ekf_equivalent(nl, nl.measurement_model, 4) is None
    assert _route(nl, y, "parallel")[0] == "sequential"
    r, sol = _route(nl, y, verb="forward_trajectory")
    assert r == sol.route == "fused_scan_plain"
    # UKF out of scope: augmented dynamics, a state_cov hook, rejection
    aug = _cv("ukf", f=lambda x, u, p, t, w: _t(A4) @ x + w,
              augmented_dynamics=True)
    r, ll = _route(aug, y)
    assert r == "sequential" and float(ll) == seq(aug)
    assert float(llpt.ukf_loglik_fused(aug, y, force_kernel=True)) \
        == seq(aug)
    for bad in (ukf.replace(state_cov=lambda xs, xm, W: torch.eye(4)),
                ukf.replace(reject=lambda x: x[0] > 10.0),
                ukf.replace(cholesky_fn=torch.linalg.cholesky)):
        assert not tk._supported(bad, bad.measurement_model)
        assert _route(bad, y)[0] == "sequential"
    # EKF: nonlinear -> I, time-varying Jacobian -> I, R12 and IEKF out
    ekf = _cv("ekf", f=lambda x, u, p, t: _t(A4) @ x + 0.01 * torch.sin(x))
    assert _route(ekf, y)[0] == "fused_scan_plain"
    tv = _cv("ekf", f=lambda x, u, p, t: (1.0 + 0.01 * t) * (_t(A4) @ x))
    assert tk._const_affine_kf_params(tv, tv.measurement_model, 4) is None
    tanh = _cv("ekf", f=lambda x, u, p, t: torch.tanh(_t(A4) @ x))
    assert tk._const_affine_kf_params(tanh, tanh.measurement_model, 4) \
        is None
    assert _route(tv, y)[0] == "fused_scan_plain"
    r12 = _cv("ekf", R12=0.01 * torch.ones(4, 2))
    r, ll = _route(r12, y)
    assert r == "sequential" and float(ll) == seq(r12)
    assert float(llpt.ekf_loglik_fused(r12, y, force_kernel=True)) \
        == seq(r12)
    iekf = llpt.make_iekf(lambda x, u, p, t: _t(A4) @ x,
                          lambda x, u, p, t: _t(C4) @ x, _t(R1), _t(R2),
                          ny=2, nu=0)
    assert _route(iekf, y)[0] == "sequential"


def test_static_walk_keeps_saturating_callbacks_off_h_and_k():
    """Dynamics that saturate (a clamp at ±5) or branch (at |x| > 3) away
    from the probe states pass every probe; the static walk refuses them,
    so the UKF takes kernel G and the EKF kernel I, never H or the
    temporal-parallel route."""
    _, y = _data(30, 0, 6)
    y = _t(y)
    A = _t(A4)
    for f in (lambda x, u, p, t: torch.clamp(A @ x, -5.0, 5.0),
              lambda x, u, p, t: torch.where(x.abs() > 3, 0.5 * (A @ x),
                                             A @ x)):
        ukf, ekf = _cv("ukf", f=f), _cv("ekf", f=f)
        eq = tk._equivalent_ekf(ukf, ukf.measurement_model, 0)
        assert tk._const_jacobians(eq, eq.measurement_model, 4, 0) is not None
        assert tk.affinity(ukf, 0).ekf is None
        assert tk.affinity(ekf, 0).AC is None
        assert tk._const_affine_kf_params(ekf, ekf.measurement_model, 4) \
            is None
        for filt in (ukf, ekf):
            assert _route(filt, y, "parallel")[0] == "sequential"
        r, ll = _route(ukf, y)
        assert r == "fused_scan_plain"
        assert float(ll) == float(tk.ukf_scan_plain(ukf, y)[0])


def test_affinity_verdict_is_kept_per_filter():
    """One verdict per filter and input width, redone after a change in
    place to a tensor the callbacks close over."""
    _, y = _data(40, 0, 7)
    y = _t(y)
    kf, ukf = _kf(), _cv("ukf")
    v = tk.affinity(kf, 0)
    assert tk.affinity(kf, 0) is v and torch.equal(v.AC[0], kf.A)
    assert tk.affinity(ukf, 0).ekf is tk.affinity(ukf, 0).ekf
    with torch.no_grad():
        kf.A.mul_(0.9)
    w = tk.affinity(kf, 0)
    assert w is not v and torch.equal(w.AC[0], kf.A)
    ll = llpt.loglik(kf, None, y, method="fused")
    want = llpt.loglik(kf, None, y, method="sequential")
    assert abs(float(ll) - float(want)) < 1e-5 * abs(float(want))


def test_h_does_not_read_all_zero_drives():
    """A drive that is zero at every step is passed as None (the JAX
    kernel's has_c / has_d) and gives the same recursion."""
    g = torch.Generator().manual_seed(8)
    ys = torch.randn(25, 2, generator=g)
    z4, z2 = torch.zeros(25, 4), torch.zeros(25, 2)
    c = z4.clone()
    c[3, 1] = 0.5
    assert tk.live_drives(z4, z2) == (None, None)
    cc, dd = tk.live_drives(c, z2)
    assert cc is c and dd is None
    rest = (torch.zeros(4), torch.eye(4), _t(R1), _t(R2), _t(A4), _t(C4),
            1.0)
    ll0, s0 = tk.akf_scan_plain(ys, None, None, *rest, traj=True)
    ll1, s1 = tk.akf_scan_plain(ys, z4, z2, *rest, traj=True)
    assert float(ll0) == float(ll1)
    assert all(torch.equal(a, b) for a, b in zip(s0, s1))


def test_batch_trace_and_f64_data_route_sequential():
    """Under torch.func.vmap the fused verbs take the sequential route;
    float64 data is out of the float32 kernels' scope."""
    _, y = _data(20, 0, 5)
    y = _t(y)
    ekf = _cv("ekf", f=lambda x, u, p, t: _t(A4) @ x + 0.01 * torch.sin(x))
    lls = torch.func.vmap(lambda yi: llpt.loglik(ekf, None, yi,
                                                 method="fused"))(
        torch.stack([y, -y]))
    assert llpt.last_route() == "sequential"
    want = float(llpt.loglik(ekf, None, -y, method="sequential"))
    assert abs(float(lls[1]) - want) < 1e-5 * abs(want)
    assert routing._under_batch_trace(ekf, y) is False
    assert tk._data_ok(ekf, y, None)
    assert not tk._data_ok(ekf, y.double(), None)


def test_plain_twins_on_zero_and_one_steps():
    ekf = _cv("ekf", f=lambda x, u, p, t: _t(A4) @ x + 0.01 * torch.sin(x))
    ll, outs = tk.ekf_scan_plain(ekf, torch.zeros(0, 2))
    assert float(ll) == 0.0 and outs is None
    ll, outs = tk.ekf_scan_plain(ekf, torch.zeros(1, 2), traj=True)
    assert float(ll) < 0.0 and [o.shape[0] for o in outs] == [1] * 7


def _cv_h(r1, T, seed=0):
    """Kernel H's inputs on the CV model without drives: P0 = 0.5 I,
    R1 = r1 I, R2 = I, y standard normal."""
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(T, 2, generator=g), None, None, torch.zeros(4),
            0.5 * torch.eye(4), r1 * torch.eye(4), _t(R2), _t(A4), _t(C4),
            1.0)


@pytest.mark.parametrize("r1, T, frozen", [(0.1, 300, True),
                                           (1e-4, 2000, True),
                                           (0.1, 50, False)])
def test_h_freeze_step_splits_prefix_and_tail(r1, T, frozen):
    """The step from which kernel H runs its parallel tail: the twin's
    R(t|t-1), S and K are the same at every step from the last Riccati
    update on, and moved at the update before; R1 = 1e-4 I (G close to 1)
    freezes later; at T = 50 nothing freezes and the prefix is all."""
    args = _cv_h(r1, T)
    tf = tk.akf_freeze_step(*args[4:], T)
    _, (x, R, xt, Rt, e, S, K) = tk.akf_scan_plain(*args, traj=True)
    if not frozen:
        assert tf == T
        return
    assert 50 < tf < T
    for M in (R, Rt, S, K):
        assert all(torch.equal(M[t], M[tf - 1]) for t in range(tf, T))
    assert not torch.equal(R[tf - 2], R[tf - 1])


def test_h_tail_reassociation_with_g_close_to_one():
    """The tail's scan as kernel H computes it, in float32 PyTorch ops: 256
    chunks of L steps, each run from zero (chunk 0 from x(t_f)), the
    chunk ends combined by a Kogge-Stone scan whose level d multiplies by
    G^{L 2^d} (G^L by squaring), then every chunk rerun from its start.
    At G close to 1 (CV, R1 = 1e-4 I) the states stay within the
    kernel-to-twin bounds of the serial recursion, and no farther from
    the float64 recursion than the serial float32 one is."""
    T = 5000
    ys, *_, P0, R1_, R2_, A, C, alpha = _cv_h(1e-4, T)
    eye = torch.eye(2)
    R, conv = P0, False
    while not conv:
        _, _, Kt, _, _, R, conv = tk._riccati(R, A, C, R1_, R2_, alpha, eye)
    KtAt = Kt @ A.mT
    G = A.mT - C.mT @ KtAt
    b = ys @ KtAt
    x0 = torch.randn(4, generator=torch.Generator().manual_seed(1))

    def serial(G, b, x0):
        xs, x = [], x0
        for t in range(b.shape[0]):
            xs.append(x)
            x = x @ G + b[t]
        return torch.stack(xs)

    P = 256
    L = -(-T // P)
    nc = -(-T // L)
    bp = torch.cat([b, b.new_zeros(nc * L - T, 4)]).reshape(nc, L, 4)
    s = torch.zeros(nc, 4)
    s[0] = x0
    for l in range(L):
        s = s @ G + bp[:, l]
    H = torch.eye(4)
    base, e = G.clone(), L
    while e:
        if e & 1:
            H = H @ base
        e >>= 1
        base = base @ base
    d = 0
    while (1 << d) < nc:
        o = 1 << d
        s = torch.cat([s[:o], s[o:] + s[:-o] @ H])
        H, d = H @ H, d + 1
    starts = torch.cat([x0[None], s[:-1]])
    chunked = torch.cat([serial(G, bp[k], starts[k]) for k in range(nc)])[:T]
    want = serial(G, b, x0)
    torch.testing.assert_close(chunked, want, rtol=2e-4, atol=1e-5)
    truth = serial(G.double(), b.double(), x0.double())
    err_chunked = float((chunked.double() - truth).abs().max())
    err_serial = float((want.double() - truth).abs().max())
    assert err_chunked <= max(2 * err_serial, 1e-6)
