"""PyTorch port: the smoothers of smoothing.py (RTS, MBF, the UKF and EKF
backward passes), the iterated parallel smoothers of parallel/temporal.py
and the ``smooth`` verb's routes, against the JAX package's.

Parity runs in float64 on the CPU, on the same numpy inputs, with rtol
1e-9 and atol 1e-10: the same formulas, summed in other orders (and the
port's Hillis–Steele scan associates the combines unlike
``jax.lax.associative_scan``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import A, B, np_of

import lowlevelparticlefilters_jl_tpu as llpf
import lowlevelparticlefilters_jl_tpu_torch as llpt
from lowlevelparticlefilters_jl_tpu.parallel import temporal as jtp
from lowlevelparticlefilters_jl_tpu_torch import convert, routing
from lowlevelparticlefilters_jl_tpu_torch.parallel import temporal as ttp

TOL = dict(rtol=1e-9, atol=1e-10)
DT = 0.1
A4 = np.array([[1, 0, DT, 0], [0, 1, 0, DT], [0, 0, 1, 0], [0, 0, 0, 1.0]])
B4 = np.array([[0, 0], [0, 0], [DT, 0], [0, DT]])
C4 = np.array([[1, 0, 0, 0], [0, 1, 0, 0.0]])
R1, R2 = 0.1 * np.eye(4), np.eye(2)
D0M, D0C = np.array([0.1, -0.2, 0.3, 0.0]), 0.5 * np.eye(4)
R1_2, R2_2 = 0.01 * np.eye(2), 0.1 * np.eye(2)


def _close(got, want, what):
    np.testing.assert_allclose(np_of(got), np_of(want), err_msg=what, **TOL)


def _data(T, seed, nu=2):
    rng = np.random.default_rng(seed)
    return 0.3 * rng.normal(size=(T, nu)), rng.normal(size=(T, 2))


def _callbacks(nonlinear):
    """(f, g) for JAX and for torch: the CV model with inputs; with
    ``nonlinear`` a 0.01 sin(x) dynamics term and a tanh measurement."""
    Aj, At = jnp.asarray(A4), torch.tensor(A4)
    Bj, Bt = jnp.asarray(B4), torch.tensor(B4)
    Cj, Ct = jnp.asarray(C4), torch.tensor(C4)
    if not nonlinear:
        return ((lambda x, u, p, t: Aj @ x + Bj @ u,
                 lambda x, u, p, t: Cj @ x),
                (lambda x, u, p, t: At @ x + Bt @ u,
                 lambda x, u, p, t: Ct @ x))
    return ((lambda x, u, p, t: Aj @ x + Bj @ u + 0.01 * jnp.sin(x),
             lambda x, u, p, t: Cj @ x + 0.05 * jnp.tanh(x[:2])),
            (lambda x, u, p, t: At @ x + Bt @ u + 0.01 * torch.sin(x),
             lambda x, u, p, t: Ct @ x + 0.05 * torch.tanh(x[:2])))


def _filters(kind, nonlinear):
    (fj, gj), (ft, gt) = _callbacks(nonlinear)
    d0j = llpf.MvNormal(jnp.asarray(D0M), jnp.asarray(D0C))
    d0t = llpt.MvNormal(torch.tensor(D0M), torch.tensor(D0C))
    make_j, make_t = ((llpf.make_ukf, llpt.make_ukf) if kind == "ukf"
                      else (llpf.make_ekf, llpt.make_ekf))
    return (make_j(fj, gj, jnp.asarray(R1), jnp.asarray(R2), d0=d0j, nu=2,
                   ny=2),
            make_t(ft, gt, torch.tensor(R1), torch.tensor(R2), d0=d0t, nu=2,
                   ny=2))


def _kalman(T, seed=0):
    """A 3-state KF with an input and a time-varying A (the MBF
    smoother's step shift shows only there)."""
    rng = np.random.default_rng(seed)
    A_ = 0.9 * np.eye(3) + 0.05 * rng.normal(size=(T, 3, 3))
    B_, C_ = rng.normal(size=(3, 1)), rng.normal(size=(2, 3))
    R1_ = 0.01 * np.eye(3) + 0.002 * np.ones((3, 3))
    d0m, d0c = rng.normal(size=3), 0.5 * np.eye(3)
    kj = llpf.KalmanFilter(jnp.asarray(A_), jnp.asarray(B_), jnp.asarray(C_),
                           0, jnp.asarray(R1_), 0.1 * jnp.eye(2),
                           d0=llpf.MvNormal(jnp.asarray(d0m),
                                            jnp.asarray(d0c)))
    kt = convert.kalman_filter_from_numpy(A_, B_, C_, 0, R1_, 0.1 * np.eye(2),
                                          d0m, d0c, device="cpu")
    return kj, kt, rng.normal(size=(T, 1)), rng.normal(size=(T, 2))


def test_rts_and_mbf_match_jax():
    """On one shared forward pass (``convert.kalman_solution_from_numpy``)
    and through each package's own ``smooth``."""
    kj, kt, u, y = _kalman(30)
    sj = llpf.forward_trajectory(kj, jnp.asarray(u), jnp.asarray(y),
                                 method="sequential")
    st = convert.kalman_solution_from_numpy(sj, device="cpu")
    rj, rt = llpf.rts_smooth(sj, kj), llpt.rts_smooth(st, kt)
    for f in ("xT", "RT"):
        _close(getattr(rt, f), getattr(rj, f), f"rts {f}")
    mj, mt = llpf.smooth_mbf(sj, kj), llpt.smooth_mbf(st, kt)
    _close(mt[0].xT, mj[0].xT, "mbf xT")
    _close(mt[0].RT, mj[0].RT, "mbf RT")
    for i, name in ((1, "ll"), (2, "lam_tilde"), (3, "lam_hat"), (4, "r")):
        _close(mt[i], mj[i], f"mbf {name}")
    # the MBF and RTS smoothers agree with each other
    _close(mt[0].xT, rt.xT, "mbf vs rts")
    own_t = llpt.smooth(kt, torch.tensor(u), torch.tensor(y),
                        method="sequential")
    assert llpt.last_route("smooth") == "sequential"
    _close(own_t.xT, rj.xT, "smooth xT")
    _close(own_t.RT, rj.RT, "smooth RT")
    assert own_t.xt is own_t.sol.xt


@pytest.mark.parametrize("kind", ["ukf", "ekf"])
def test_ukf_ekf_smooth_match_jax(kind):
    """The sequential unscented and extended RTS smoothers (the
    nonlinear CV model, inputs, 40 steps)."""
    fj, ft = _filters(kind, nonlinear=True)
    u, y = _data(40, 5)
    sj = fj.smooth(jnp.asarray(u), jnp.asarray(y))
    st = ft.smooth(torch.tensor(u), torch.tensor(y))
    for f in ("xT", "RT", "xt", "Rt", "ll"):
        _close(getattr(st, f), getattr(sj, f), f"{kind} {f}")
    own = llpt.smooth(ft, torch.tensor(u), torch.tensor(y))
    assert llpt.last_route("smooth") == "sequential"
    _close(own.xT, st.xT, "smooth verb")


def _filters2(kind, nonlinear):
    """The benchmark's 2-state model with an input as a UKF or EKF, with
    ``nonlinear`` a 0.05 sin(x) dynamics and a tanh measurement term, in
    both packages."""
    k = 0.05 if nonlinear else 0.0
    (Aj, At), (Bj, Bt) = ((jnp.asarray(M), torch.tensor(M)) for M in (A, B))
    fj = lambda x, u, p, t: Aj @ x + Bj @ u + k * jnp.sin(x)  # noqa: E731
    ft = lambda x, u, p, t: At @ x + Bt @ u + k * torch.sin(x)  # noqa: E731
    gj = lambda x, u, p, t: x + k * jnp.tanh(x)  # noqa: E731
    gt = lambda x, u, p, t: x + k * torch.tanh(x)  # noqa: E731
    if not nonlinear:
        gj = lambda x, u, p, t: 1.0 * x  # noqa: E731
        gt = lambda x, u, p, t: 1.0 * x  # noqa: E731
    make_j, make_t = ((llpf.make_ukf, llpt.make_ukf) if kind == "ukf"
                      else (llpf.make_ekf, llpt.make_ekf))
    return (make_j(fj, gj, jnp.asarray(R1_2), jnp.asarray(R2_2), nu=1, ny=2),
            make_t(ft, gt, torch.tensor(R1_2), torch.tensor(R2_2), nu=1,
                   ny=2))


def _eager_scan(f, init, xs, length=None, **_):
    """``jax.lax.scan`` with ``xs=None`` as a Python loop: the iterated
    smoothers' refinement scan, whose plane body takes from 15 s to
    minutes to compile on the CPU, run op by op instead."""
    carry = init
    for _ in range(length):
        carry, _y = f(carry, None)
    return carry, None


@pytest.mark.parametrize("nonlinear", [False, True])
@pytest.mark.parametrize("kind", ["ukf", "ekf"])
def test_parallel_iterated_smoothers_match_jax(kind, nonlinear, monkeypatch):
    """``parallel_ukf_smooth`` and ``parallel_iekf_smooth`` at T = 64,
    iters = 2: the affine models take the one-pass branch in both
    packages (their static walks agree), the nonlinear ones refine once.
    The JAX refinement runs eagerly (:func:`_eager_scan`), the same
    arithmetic as its compiled scan."""
    monkeypatch.setattr(jax.lax, "scan", _eager_scan)
    fj, ft = _filters2(kind, nonlinear)
    rng = np.random.default_rng(6)
    u, y = 0.3 * rng.normal(size=(64, 1)), rng.normal(size=(64, 2))
    fn_j, fn_t = ((jtp.parallel_ukf_smooth, ttp.parallel_ukf_smooth)
                  if kind == "ukf" else
                  (jtp.parallel_iekf_smooth, ttp.parallel_iekf_smooth))
    sj = fn_j(fj, jnp.asarray(u), jnp.asarray(y), iters=2)
    st = fn_t(ft, torch.tensor(u), torch.tensor(y), iters=2)
    for f in ("xT", "RT", "x", "xt", "R", "Rt", "e", "S", "K", "ll", "t",
              "ok"):
        _close(getattr(st, f), getattr(sj, f), f"{kind} {f}")
    assert st.sol.route == "temporal_parallel_plain"
    st1 = fn_t(ft, torch.tensor(u), torch.tensor(y), iters=1)
    if nonlinear:  # the refinement moved the nominal trajectory
        assert not torch.allclose(st1.xT, st.xT, rtol=1e-9, atol=1e-10)
    else:  # affine: one pass is the fixed point
        _close(st1.xT, st.xT, "iters 1 vs 2")


def test_slr_many_matches_jax():
    """The wide-state SLR (one Gaussian, two functions)."""
    (_, gj), (_, gt) = _callbacks(nonlinear=True)
    fj = lambda x: jnp.sin(x) + 0.5 * x  # noqa: E731
    ft = lambda x: torch.sin(x) + 0.5 * x  # noqa: E731
    rng = np.random.default_rng(9)
    m = rng.normal(size=4)
    P = D0C + 0.1 * np.ones((4, 4))
    for params_j, params_t in ((llpf.MerweParams(0.5),
                                llpt.MerweParams(0.5)),):
        Wj = llpf.ukf_weights(params_j, 4)
        Wt = llpt.ukf_weights(params_t, 4)
        outj, xsj = jtp._slr_many(
            (fj, lambda x: gj(x, None, None, 0.0)), jnp.asarray(m),
            jnp.asarray(P), Wj, params_j)
        outt, xst = ttp._slr_many(
            (ft, lambda x: gt(x, None, None, 0.0)), torch.tensor(m),
            torch.tensor(P), Wt, params_t)
        _close(xst, xsj, "sigma points")
        for a, b in zip(outt, outj):
            for name, ta, ja in zip(("F", "c", "Om"), a, b):
                _close(ta, ja, name)


def _headline_kf(T):
    kt = convert.kalman_filter_from_numpy(A4, None, C4, 0, R1, R2,
                                          device="cpu")
    return kt, torch.tensor(np.random.default_rng(2).normal(size=(T, 2)))


def test_route_smooth_decisions(monkeypatch):
    """CPU tensors: ``auto`` is the sequential backward pass,
    ``"parallel"`` the temporal-parallel smoothers.  With the CUDA
    admission of ``auto`` stood in for (T >= T_PARALLEL), a KF takes
    ``parallel_rts_smooth``, a UKF ``parallel_ukf_smooth`` and an EKF
    ``parallel_iekf_smooth``, each as its direct call; an augmented UKF,
    a call with ``p`` or with extra keywords, and a short record stay
    sequential."""
    kt, y = _headline_kf(20)
    seq = llpt.smooth(kt, None, y)
    assert llpt.last_route("smooth") == "sequential"
    par = llpt.smooth(kt, None, y, method="parallel")
    assert llpt.last_route("smooth") == par.route == "temporal_parallel_plain"
    _close(par.xT, seq.xT, "parallel vs sequential KF")
    with pytest.raises(ValueError):
        llpt.smooth(kt, None, y, method="nope")

    monkeypatch.setattr(routing, "_want_parallel", lambda method, y, T: (
        method == "parallel" or method == "auto"
        and T >= routing.T_PARALLEL))
    T = routing.T_PARALLEL
    kt, y = _headline_kf(T)
    u = torch.zeros(T, 1, dtype=torch.float64)
    out = llpt.smooth(kt, None, y)
    assert llpt.last_route("smooth") == out.route == "temporal_parallel_plain"
    _close(out.xT, llpt.parallel_rts_smooth(kt, None, y).xT, "KF route")
    llpt.smooth(kt, None, y[:T - 1])
    assert llpt.last_route("smooth") == "sequential"
    _, ukf = _filters2("ukf", nonlinear=True)
    _, ekf = _filters2("ekf", nonlinear=True)
    for f, fn in ((ukf, llpt.parallel_ukf_smooth),
                  (ekf, llpt.parallel_iekf_smooth)):
        out = llpt.smooth(f, u, y)
        assert llpt.last_route("smooth") == "temporal_parallel_plain"
        _close(out.xT, fn(f, u, y).xT, f"{type(f).__name__} route")
    y40, u40 = y[:40], u[:40]
    llpt.smooth(ekf, u40, y40, method="parallel", p=())
    assert llpt.last_route("smooth") == "sequential"
    aug = ukf.replace(augmented_dynamics=True, nw=2,
                      dynamics=lambda x, u, p, t, w: x + w)
    llpt.smooth(aug, u40, y40, method="parallel")
    assert llpt.last_route("smooth") == "sequential"


def test_smoothed_helpers_match_jax():
    xb = np.random.default_rng(4).normal(size=(5, 7, 3))
    for name in ("smoothed_mean", "smoothed_cov", "smoothed_trajs"):
        _close(getattr(llpt, name)(torch.tensor(xb)),
               getattr(llpf, name)(jnp.asarray(xb)), name)
