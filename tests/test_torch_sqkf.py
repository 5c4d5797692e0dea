"""PyTorch port: the square-root filters (filters/sqkf.py) against the
JAX package, on the models of tests/test_sqkf.py, in float64 on the
same numpy inputs.

Deterministic recursions: ``forward_trajectory`` (x, xt, R, Rt, ll),
``smooth`` (xT, RT and the factors U, Ut, UT in ``sol.extra``) and the
measurement-model dispatch within rtol 1e-9 (atol 1e-12); the QR factors
are taken with a positive diagonal in both packages, so they agree
whatever sign each QR routine returns.  ``smooth`` reaches the filter's
own factored smoother on every ``method``: no kernel takes a SqKF.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import np_of

import lowlevelparticlefilters_jl_tpu as llpf
import lowlevelparticlefilters_jl_tpu_torch as llpt
from lowlevelparticlefilters_jl_tpu_torch import convert

A = np.array([[1.0, 0.1], [0.0, 0.97]])
B = np.array([[0.005], [0.1]])
C = np.array([[1.0, 0.0]])
R1 = np.array([[0.005, 0.0], [0.0, 0.01]])
R2 = 0.1 * np.eye(1)
T = 40
TOL = dict(rtol=1e-9, atol=1e-12)


def _data(seed=11):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(T, 1)), rng.normal(size=(T, 1))


def _jax_sqkf():
    return llpf.SqKalmanFilter(A, B, C, 0, R1, R2,
                               d0=llpf.MvNormal(jnp.zeros(2),
                                                jnp.asarray(2 * R1)))


def _port_sqkf():
    return convert.sqkf_from_numpy(A, B, C, 0, R1, R2, None, 2 * R1,
                                   device="cpu")


def _nl(xp):
    """The nonlinear model of tests/test_sqkf.py in ``xp`` (jnp/torch)."""
    def dyn(x, u, p, t):
        return xp.stack([0.9 * x[0] + 0.1 * xp.sin(x[1]), 0.95 * x[1]]) \
            + xp.asarray([0.0, 0.1], dtype=x.dtype) * u[0]

    def meas(x, u, p, t):
        return (x[0] + 0.05 * x[0] ** 2).reshape(1)

    return dyn, meas


def _close(got, want, what):
    np.testing.assert_allclose(np_of(got), np_of(want), err_msg=what, **TOL)


def _check_smooth(st, sj):
    for f in ("xT", "RT"):
        _close(getattr(st, f), getattr(sj, f), f)
    for f in ("x", "xt", "R", "Rt", "ll", "e", "K", "S"):
        _close(getattr(st.sol, f), getattr(sj.sol, f), f)
    for k in ("U", "Ut", "UT"):
        _close(st.sol.extra[k], sj.sol.extra[k], k)


@pytest.mark.parametrize("method", ["auto", "parallel"])
def test_sqkf_forward_and_smooth_match_jax(method):
    u, y = _data()
    fj, ft = _jax_sqkf(), _port_sqkf()
    uj, yj, ut, yt = jnp.asarray(u), jnp.asarray(y), torch.tensor(u), \
        torch.tensor(y)
    sj = llpf.forward_trajectory(fj, uj, yj)
    st = llpt.forward_trajectory(ft, ut, yt)
    assert st.route == "sequential"
    for f in ("x", "xt", "R", "Rt", "ll", "e", "K", "S"):
        _close(getattr(st, f), getattr(sj, f), f)
    _close(llpt.loglik(ft, ut, yt), llpf.loglik(fj, uj, yj), "loglik")
    # smooth reaches the factored smoother whatever the method asks
    sm = llpt.smooth(ft, ut, yt, method=method)
    assert llpt.last_route("smooth") == "sequential"
    _check_smooth(sm, llpf.smooth(fj, uj, yj))
    # and agrees with the plain KF's RTS smoother (the oracle)
    kf = convert.kalman_filter_from_numpy(A, B, C, 0, R1, R2, None, 2 * R1,
                                          device="cpu")
    ref = llpt.smooth(kf, ut, yt, method="sequential")
    np.testing.assert_allclose(np_of(sm.xT), np_of(ref.xT), rtol=1e-8,
                               atol=1e-10)
    np.testing.assert_allclose(float(sm.sol.ll), float(ref.sol.ll),
                               rtol=1e-10)


def test_sqekf_forward_and_smooth_match_jax():
    """The nonlinear model: ``torch.func.jacfwd`` Jacobians, the
    re-linearized factored smoother."""
    rng = np.random.default_rng(3)
    u = 0.3 * rng.normal(size=(T, 1))
    y = rng.normal(size=(T, 1))
    Rn1, Rn2, P0 = 0.01 * np.eye(2), 0.1 * np.eye(1), 0.5 * np.eye(2)
    fj = llpf.make_sqekf(*_nl(jnp), Rn1, Rn2,
                         d0=llpf.MvNormal(jnp.zeros(2), jnp.asarray(P0)),
                         nu=1, ny=1)
    ft = convert.sqekf_from_numpy(*_nl(torch), Rn1, Rn2, None, P0, nu=1,
                                  device="cpu")
    uj, yj, ut, yt = jnp.asarray(u), jnp.asarray(y), torch.tensor(u), \
        torch.tensor(y)
    sj, st = llpf.forward_trajectory(fj, uj, yj), \
        llpt.forward_trajectory(ft, ut, yt)
    for f in ("x", "xt", "R", "Rt", "ll"):
        _close(getattr(st, f), getattr(sj, f), f)
    _check_smooth(llpt.smooth(ft, ut, yt), llpf.smooth(fj, uj, yj))


def test_sqkf_measurement_model_dispatch_matches_jax():
    """``correct(mm=...)``: a linear and an EKF model on the QR path, a
    UKF model through the full-covariance round trip, as in the JAX
    package; then one predict."""
    u, y = _data(2)
    fj, ft = _jax_sqkf(), _port_sqkf()
    C2 = np.array([[0.0, 1.0]])
    mms = (
        (llpf.LinearMeasurementModel(C=jnp.asarray(C), R2=jnp.asarray(R2),
                                     ny=1),
         llpt.LinearMeasurementModel(C=torch.tensor(C), R2=torch.tensor(R2))),
        (llpf.EKFMeasurementModel(
            measurement=lambda x, u, p, t: jnp.asarray(C2) @ x,
            R2=0.05 * jnp.eye(1), ny=1),
         llpt.EKFMeasurementModel(
             measurement=lambda x, u, p, t: torch.tensor(C2) @ x,
             R2=0.05 * torch.eye(1, dtype=torch.float64))),
        (llpf.UKFMeasurementModel(
            measurement=lambda x, u, p, t: jnp.asarray(C) @ x,
            R2=jnp.asarray(R2), ny=1),
         llpt.UKFMeasurementModel(
             measurement=lambda x, u, p, t: torch.tensor(C) @ x,
             R2=torch.tensor(R2))))
    sj, st = fj.init(), ft.init()
    for k, (mj, mt) in enumerate(mms):
        sj, ij = fj.correct(sj, jnp.asarray(u[k]), jnp.asarray(y[k]), mm=mj)
        st, it = ft.correct(st, torch.tensor(u[k]), torch.tensor(y[k]),
                            mm=mt)
        _close(st.x, sj.x, f"x after model {k}")
        _close(st.U, sj.U, f"U after model {k}")
        _close(it.ll, ij.ll, f"ll of model {k}")
    sj = fj.predict(sj, jnp.asarray(u[3]))
    st = ft.predict(st, torch.tensor(u[3]))
    _close(st.U, sj.U, "U after predict")
    assert st.t == 1


def test_sqkf_convert_round_trip():
    """``convert.sqkf_from_numpy`` / ``sqekf_from_numpy`` build the
    filters the direct constructors build: the same factors (once: a
    ``replace`` does not factor again) and the same initial state."""
    ft = _port_sqkf()
    direct = llpt.SqKalmanFilter(
        torch.tensor(A), torch.tensor(B), torch.tensor(C), 0,
        torch.tensor(R1), torch.tensor(R2),
        d0=llpt.MvNormal(torch.zeros(2, dtype=torch.float64),
                         torch.tensor(2 * R1)))
    for name in ("A", "B", "C", "R1", "R2"):
        assert torch.equal(getattr(ft, name), getattr(direct, name)), name
    assert ft.D is None and (ft.nx, ft.nu, ft.ny) == (2, 1, 1)
    np.testing.assert_allclose(np_of(ft.R1.mT @ ft.R1), R1, rtol=1e-14)
    assert torch.equal(ft.replace(alpha=1.0).R1, ft.R1)
    fe = convert.sqekf_from_numpy(*_nl(torch), R1, R2, None, 2 * R1,
                                  device="cpu")
    assert fe.nx == 2 and fe.ny == 1
    np.testing.assert_allclose(np_of(fe.R1), np_of(ft.R1), rtol=1e-14)
    assert torch.equal(fe.init().U, ft.init().U)
