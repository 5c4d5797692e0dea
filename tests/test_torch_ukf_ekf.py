"""PyTorch port: the measurement models, the UKF (additive and augmented,
Merwe weights, manifold hooks, rejection) and the EKF/IEKF against the
JAX package's sequential recursion, float64, rtol 1e-9 (the same
algebra; only the rounding of the sums differs)."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import np_of

import lowlevelparticlefilters_jl_tpu as llpf
import lowlevelparticlefilters_jl_tpu_torch as llpt
from lowlevelparticlefilters_jl_tpu.filters.kalman import KFState as JState
from lowlevelparticlefilters_jl_tpu_torch import convert
from lowlevelparticlefilters_jl_tpu_torch.filters.kalman import KFState

RTOL = dict(rtol=1e-9, atol=1e-11)
T = 40
DT = 0.1
A4 = np.array([[1, 0, DT, 0], [0, 1, 0, DT], [0, 0, 1, 0], [0, 0, 0, 1.0]])
B4 = np.array([[0, 0], [0, 0], [DT, 0], [0, DT]])
C4 = np.array([[1, 0, 0, 0], [0, 1, 0, 0.0]])
R1, R2 = 0.1 * np.eye(4), np.eye(2)
D0M, D0C = np.array([0.1, -0.2, 0.3, 0.0]), 0.5 * np.eye(4)
FIELDS = ("x", "xt", "R", "Rt", "e", "S", "K", "ll")


def _both(a):
    return jnp.asarray(a), torch.tensor(a)


def _data(seed, nu=2):
    rng = np.random.default_rng(seed)
    return 0.3 * rng.normal(size=(T, nu)), rng.normal(size=(T, 2))


def _callbacks(nonlinear):
    """(f, g) for JAX and for torch: the CV model with inputs, plus
    0.01 sin(x) in the dynamics when ``nonlinear``."""
    (Aj, At), (Bj, Bt), (Cj, Ct) = (_both(M) for M in (A4, B4, C4))
    k = 0.01 if nonlinear else 0.0
    return ((lambda x, u, p, t: Aj @ x + Bj @ u + k * jnp.sin(x),
             lambda x, u, p, t: Cj @ x + 0.05 * jnp.tanh(x[:2])),
            (lambda x, u, p, t: At @ x + Bt @ u + k * torch.sin(x),
             lambda x, u, p, t: Ct @ x + 0.05 * torch.tanh(x[:2])))


def _compare(fj, ft, u, y, fields=FIELDS):
    sj = llpf.forward_trajectory(fj, jnp.asarray(u), jnp.asarray(y),
                                 method="sequential")
    st = llpt.forward_trajectory(ft, torch.tensor(u), torch.tensor(y))
    assert llpt.last_route("forward_trajectory") == "sequential"
    for f in fields:
        np.testing.assert_allclose(np_of(getattr(st, f)),
                                   np_of(getattr(sj, f)), err_msg=f,
                                   **RTOL)
    assert bool(st.ok.all())
    return sj, st


def _d0(lib, arr):
    return lib.MvNormal(arr(D0M), arr(D0C))


def test_ekf_forward_trajectory_and_loglik():
    (fj, gj), (ft, gt) = _callbacks(nonlinear=True)
    ej = llpf.make_ekf(fj, gj, jnp.asarray(R1), jnp.asarray(R2),
                       d0=_d0(llpf, jnp.asarray), nu=2, ny=2, alpha=1.02)
    et = convert.ekf_from_numpy(ft, gt, R1, R2, D0M, D0C, alpha=1.02, nu=2,
                                dtype=torch.float64, device="cpu")
    u, y = _data(0)
    sj, _ = _compare(ej, et, u, y)
    llt = llpt.loglik(et, torch.tensor(u), torch.tensor(y))
    assert llpt.last_route() == "sequential"
    np.testing.assert_allclose(float(llt), float(sj.ll), rtol=1e-9)


def test_iekf_forward_trajectory():
    (fj, gj), (ft, gt) = _callbacks(nonlinear=True)
    gj2 = lambda x, u, p, t: jnp.stack([x[0] ** 2 / 3 + x[1], x[1]])  # noqa
    gt2 = lambda x, u, p, t: torch.stack([x[0] ** 2 / 3 + x[1], x[1]])  # noqa
    ij = llpf.make_iekf(fj, gj2, jnp.asarray(R1), jnp.asarray(R2),
                        d0=_d0(llpf, jnp.asarray), nu=2, ny=2, maxiters=4)
    it = llpt.make_iekf(ft, gt2, torch.tensor(R1), torch.tensor(R2),
                        d0=_d0(llpt, torch.tensor), nu=2, ny=2, maxiters=4)
    u, y = _data(1)
    _compare(ij, it, u, y)


@pytest.mark.parametrize("case", ["trivial", "merwe", "augmented"])
def test_ukf_forward_trajectory(case):
    (fj, gj), (ft, gt) = _callbacks(nonlinear=True)
    kw = dict(ny=2, nu=2)
    if case == "merwe":
        kw_j = dict(weight_params=llpf.MerweParams(alpha=0.5, beta=2.0))
        kw_t = dict(weight_params=llpt.MerweParams(alpha=0.5, beta=2.0))
    elif case == "augmented":
        fj_, ft_ = fj, ft
        fj = lambda x, u, p, t, w: fj_(x, u, p, t) + w  # noqa: E731
        ft = lambda x, u, p, t, w: ft_(x, u, p, t) + w  # noqa: E731
        gj_, gt_ = gj, gt
        gj = lambda x, u, p, t, e: gj_(x, u, p, t) + jnp.sin(e)  # noqa
        gt = lambda x, u, p, t, e: gt_(x, u, p, t) + torch.sin(e)  # noqa
        kw_j = kw_t = dict(augmented_dynamics=True,
                           augmented_measurement=True)
    else:
        kw_j = kw_t = {}
    uj = llpf.make_ukf(fj, gj, jnp.asarray(R1), jnp.asarray(R2),
                       d0=_d0(llpf, jnp.asarray), **kw, **kw_j)
    if case == "merwe":  # the NumPy builder, as a JAX model carries over
        ut = convert.ukf_from_numpy(ft, gt, R1, R2, D0M, D0C, nu=2,
                                    dtype=torch.float64, device="cpu", **kw_t)
    else:
        ut = llpt.make_ukf(ft, gt, torch.tensor(R1), torch.tensor(R2),
                           d0=_d0(llpt, torch.tensor), **kw, **kw_t)
    u, y = _data(2)
    _compare(uj, ut, u, y)


def _wrap_j(a):
    return jnp.mod(a + jnp.pi, 2 * jnp.pi) - jnp.pi


def _wrap_t(a):
    return torch.remainder(a + math.pi, 2 * math.pi) - math.pi


def test_ukf_manifold_hooks_and_reject():
    """Angle-wrap innovation and state mean, a custom measurement mean,
    and sigma-point rejection."""
    def hooks(lib, wrap, stack):
        def dyn(x, u, p, t):
            return stack([wrap(x[0] + 0.1 * x[1]), 0.98 * x[1]])

        def smean(xs, W):
            w = lib.concatenate([xs[:1, 0] * 0 + W.wm,
                                 xs[1:, 0] * 0 + W.wmi])
            return stack([wrap((w * xs[:, 0]).sum()), (w * xs[:, 1]).sum()])

        def ymean(ys, W):
            return W.wm * ys[0] + W.wmi * ys[1:].sum(0)

        return dyn, smean, ymean

    dj, smj, ymj = hooks(jnp, _wrap_j, jnp.stack)
    dt_, smt, ymt = hooks(type("T", (), {"concatenate": staticmethod(
        torch.cat)}), _wrap_t, torch.stack)
    R1a, R2a, d0m, d0c = np.diag([0.01, 0.001]), 0.05 * np.eye(1), \
        np.array([0.3, 0.1]), 0.2 * np.eye(2)
    mmj = llpf.UKFMeasurementModel(
        measurement=lambda x, u, p, t: x[:1], R2=jnp.asarray(R2a), ny=1,
        innovation=lambda y, yh: _wrap_j(y - yh), mean=ymj)
    mmt = llpt.UKFMeasurementModel(
        measurement=lambda x, u, p, t: x[:1], R2=torch.tensor(R2a), ny=1,
        innovation=lambda y, yh: _wrap_t(y - yh), mean=ymt)
    uj = llpf.UnscentedKalmanFilter(
        dynamics=dj, measurement_model=mmj, R1=jnp.asarray(R1a),
        d0=llpf.MvNormal(jnp.asarray(d0m), jnp.asarray(d0c)), nu=0,
        state_mean=smj, reject=lambda x: x[1] > 0.45)
    ut = llpt.UnscentedKalmanFilter(
        dynamics=dt_, measurement_model=mmt, R1=torch.tensor(R1a),
        d0=llpt.MvNormal(torch.tensor(d0m), torch.tensor(d0c)), nu=0,
        state_mean=smt, reject=lambda x: x[1] > 0.45)
    ang = np.cumsum(0.12 * np.ones(T)) - 2.0
    y = (np.mod(ang + np.pi, 2 * np.pi) - np.pi)[:, None] \
        + 0.1 * np.random.default_rng(3).normal(size=(T, 1))
    sj = llpf.forward_trajectory(uj, None, jnp.asarray(y),
                                 method="sequential")
    st = llpt.forward_trajectory(ut, None, torch.tensor(y))
    for f in FIELDS:
        np.testing.assert_allclose(np_of(getattr(st, f)),
                                   np_of(getattr(sj, f)), err_msg=f,
                                   **RTOL)


def test_measurement_model_corrections():
    """``correct`` of each measurement model (linear with D and with R12,
    EKF, IEKF, UKF additive and augmented, composite) from the same
    state, with an EKF as the owning filter."""
    (fj, gj), (ft, gt) = _callbacks(nonlinear=False)
    rng = np.random.default_rng(4)
    x, u, y = rng.normal(size=4), 0.3 * rng.normal(size=2), \
        rng.normal(size=2)
    R = D0C + 0.1 * np.ones((4, 4))
    sj = JState(x=jnp.asarray(x), R=jnp.asarray(R), t=jnp.asarray(0))
    st = KFState(x=torch.tensor(x), R=torch.tensor(R), t=0)
    D = np.array([[0.1, 0.0], [0.0, 0.2]])
    R12 = 0.01 * np.ones((4, 2))
    models = [
        (llpf.LinearMeasurementModel(jnp.asarray(C4), jnp.asarray(D),
                                     jnp.asarray(R2)),
         llpt.LinearMeasurementModel(torch.tensor(C4), torch.tensor(D),
                                     torch.tensor(R2))),
        (llpf.LinearMeasurementModel(jnp.asarray(C4), R2=jnp.asarray(R2),
                                     R12=jnp.asarray(R12)),
         llpt.LinearMeasurementModel(torch.tensor(C4), R2=torch.tensor(R2),
                                     R12=torch.tensor(R12))),
        (llpf.EKFMeasurementModel(gj, jnp.asarray(R2)),
         llpt.EKFMeasurementModel(gt, torch.tensor(R2))),
        (llpf.IEKFMeasurementModel(
            lambda x, u, p, t: jnp.stack([x[0] ** 2 / 3 + x[1], x[1]]),
            jnp.asarray(R2), maxiters=5),
         llpt.IEKFMeasurementModel(
            lambda x, u, p, t: torch.stack([x[0] ** 2 / 3 + x[1], x[1]]),
            torch.tensor(R2), maxiters=5)),
        (llpf.UKFMeasurementModel(gj, jnp.asarray(R2)),
         llpt.UKFMeasurementModel(gt, torch.tensor(R2))),
        (llpf.UKFMeasurementModel(
            lambda x, u, p, t, e: gj(x, u, p, t) + e, jnp.asarray(R2),
            augmented=True),
         llpt.UKFMeasurementModel(
            lambda x, u, p, t, e: gt(x, u, p, t) + e, torch.tensor(R2),
            augmented=True)),
    ]
    models.append((llpf.CompositeMeasurementModel((models[2][0],
                                                   models[4][0])),
                   llpt.CompositeMeasurementModel((models[2][1],
                                                   models[4][1]))))
    kj = llpf.make_ekf(fj, gj, jnp.asarray(R1), jnp.asarray(R2), nu=2, ny=2)
    kt = llpt.make_ekf(ft, gt, torch.tensor(R1), torch.tensor(R2), nu=2,
                       ny=2)
    for i, (mj, mt) in enumerate(models):
        yy = np.concatenate([y, y]) if i == len(models) - 1 else y
        nj, ij = mj.correct(kj, sj, jnp.asarray(u), jnp.asarray(yy))
        nt, it = mt.correct(kt, st, torch.tensor(u), torch.tensor(yy))
        for a, b in ((nt.x, nj.x), (nt.R, nj.R), (it.ll, ij.ll),
                     (it.e, ij.e)):
            np.testing.assert_allclose(np_of(a), np_of(b), err_msg=str(i),
                                       **RTOL)
        assert mt.ny == mj.ny


def test_constructors_and_sampling():
    (_, _), (ft, gt) = _callbacks(nonlinear=True)
    ekf = llpt.make_ekf(ft, gt, torch.tensor(R1), torch.tensor(R2), nu=2)
    assert ekf.nx == 4 and ekf.ny == 2 and ekf.names.name == "EKF"
    ukf = llpt.make_ukf(ft, gt, torch.tensor(R1), torch.tensor(R2), nu=2)
    assert ukf.nx == 4 and ukf.ny == 2 and ukf.R2 is ukf.measurement_model.R2
    u0 = torch.zeros(20, 2, dtype=torch.float64)
    x, u, y = llpt.simulate(ukf, u0, torch.Generator().manual_seed(0))
    assert x.shape == (20, 4) and y.shape == (20, 2)
    mm = ekf.measurement_model.replace(
        R12=0.01 * torch.ones(4, 2, dtype=torch.float64))
    x, _, y = ekf.replace(measurement_model=mm).simulate_correlated(
        u0, torch.Generator().manual_seed(1))
    assert x.shape == (20, 4) and bool(torch.isfinite(y).all())
    for f in (ukf, ekf):  # the RTS smoothers, sequential on the CPU
        ssol = f.smooth(u0, y)
        assert ssol.xT.shape == (20, 4) and ssol.RT.shape == (20, 4, 4)
        assert bool(torch.isfinite(ssol.xT).all())
    with pytest.raises(ValueError, match="d0"):
        llpt.make_ekf(ft, gt, None, torch.tensor(R2))
