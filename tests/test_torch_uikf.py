"""PyTorch port: the unknown-input Kalman filter (filters/uikf.py)
against the JAX package on the Darouach example of
tests/test_advanced_filters.py (a square-wave unknown input, and none),
in float64 on the same numpy inputs.

Deterministic: ``forward_trajectory`` (x, xt, R, Rt, ll, e, K and the
input estimates ``d`` in ``sol.extra``) within rtol 1e-9 (atol 1e-10:
the gain comes through an SVD whose complement basis differs between
LAPACK calls, the gain itself does not).  A user's ``post_correct_cb``
runs before the filter's own; no routing predicate takes the UIKF for
its inner KF (no kernel H or K, on any ``method``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import np_of

import lowlevelparticlefilters_jl_tpu as llpf
import lowlevelparticlefilters_jl_tpu_torch as llpt
from lowlevelparticlefilters_jl_tpu_torch import convert

A = np.array([[0.0, 0.6, 0.075], [0.75, 0.0, 0.0], [0.0, 0.75, 0.0375]])
B = np.array([[1.0], [1.0], [0.0]])
G = np.array([[0.0], [1.0], [1.0]])
C = np.array([[1.0, 1.0, 0.0], [0.0, 1.0, 1.0]])
R1 = np.diag([3.0, 6.0, 9.0])
R2 = np.diag([12.0, 12.0])
P0 = 10.0 * np.eye(3)
T = 50
TOL = dict(rtol=1e-9, atol=1e-10)


def _data(with_input: bool, seed=0):
    """A draw of the model, with the square wave d of amplitude 10 (or
    d = 0) and u ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    d = 10.0 * np.sign(np.sin(2 * np.pi * np.arange(T) / 50.0 + 0.1)) \
        if with_input else np.zeros(T)
    u = rng.normal(size=(T, 1))
    x, ys = np.zeros(3), []
    for k in range(T):
        ys.append(C @ x + rng.multivariate_normal(np.zeros(2), R2))
        x = A @ x + B @ u[k] + G[:, 0] * d[k] \
            + rng.multivariate_normal(np.zeros(3), R1)
    return u, np.array(ys)


def _pair():
    kj = llpf.KalmanFilter(A, B, C, 0, R1, R2,
                           d0=llpf.MvNormal(jnp.zeros(3), jnp.asarray(P0)))
    return (llpf.UIKalmanFilter(kf=kj, G=jnp.asarray(G)),
            convert.uikf_from_numpy(A, B, C, 0, R1, R2, G, None, P0,
                                    device="cpu"))


@pytest.mark.parametrize("with_input", [True, False],
                         ids=["square_wave", "no_input"])
def test_uikf_forward_trajectory_matches_jax(with_input):
    u, y = _data(with_input)
    fj, ft = _pair()
    sj = llpf.forward_trajectory(fj, jnp.asarray(u), jnp.asarray(y))
    st = llpt.forward_trajectory(ft, torch.tensor(u), torch.tensor(y))
    assert st.route == "sequential"
    for f in ("x", "xt", "R", "Rt", "ll", "e", "K", "extra"):
        np.testing.assert_allclose(np_of(getattr(st, f)),
                                   np_of(getattr(sj, f)), err_msg=f, **TOL)
    assert st.extra.shape == (T, 1) and bool(st.ok.all())
    if with_input:  # the estimate d(k-1) follows the square wave
        d_ref = 10.0 * np.sign(np.sin(2 * np.pi * np.arange(T) / 50.0 + 0.1))
        assert np.corrcoef(np_of(st.extra)[6:, 0], d_ref[5:-1])[0, 1] > 0.5


def test_uikf_callbacks_and_routes():
    """A user's ``post_correct_cb`` state is kept and ``d`` still lands
    in ``sol.extra`` (JAX's chaining); ``loglik`` and every ``method``
    stay on the UIKF's own sequential recursion."""
    u, y = _data(True, seed=1)
    fj, ft = _pair()
    ut, yt = torch.tensor(u), torch.tensor(y)

    def cb(xp):
        return lambda f, s, info, u, y, p, t: (s.replace(x=0.9 * s.x), None)

    sj = llpf.forward_trajectory(fj, jnp.asarray(u), jnp.asarray(y),
                                 post_correct_cb=cb(jnp))
    st = llpt.forward_trajectory(ft, ut, yt, post_correct_cb=cb(torch))
    for f in ("xt", "ll", "extra"):
        np.testing.assert_allclose(np_of(getattr(st, f)),
                                   np_of(getattr(sj, f)), err_msg=f, **TOL)
    ll = llpf.loglik(fj, jnp.asarray(u), jnp.asarray(y))
    for method in ("auto", "fused", "parallel"):
        got = llpt.loglik(ft, ut, yt, method=method)
        assert llpt.last_route("loglik") == "sequential", method
        np.testing.assert_allclose(float(got), float(ll), **TOL)
        llpt.forward_trajectory(ft, ut, yt, method=method)
        assert llpt.last_route("forward_trajectory") == "sequential"
    llpt.smooth(ft, ut, yt, method="parallel")
    assert llpt.last_route("smooth") == "sequential"


def test_uikf_convert_round_trip():
    """``convert.uikf_from_numpy`` builds the inner KF as
    ``kalman_filter_from_numpy`` does and infers nd from G; unknown
    attributes read through to the inner KF."""
    _, ft = _pair()
    kf = convert.kalman_filter_from_numpy(A, B, C, 0, R1, R2, None, P0,
                                          device="cpu")
    for name in ("A", "B", "C", "R1", "R2"):
        assert torch.equal(getattr(ft.kf, name), getattr(kf, name)), name
    assert ft.nd == 1 and torch.equal(ft.G, torch.tensor(G))
    assert ft.Ts == kf.Ts and ft.nx == 3 and ft.ny == 2
    assert torch.equal(ft.init().R, kf.init().R)
