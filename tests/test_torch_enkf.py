"""PyTorch port: the stochastic ensemble Kalman filter (filters/enkf.py)
against the JAX package, in float64 on the linear model of
tests/test_advanced_filters.py.

- Draw for draw: the port draws only through ``filters/enkf.py::_sample``;
  the test replays there the JAX package's draws from the same keys (the
  initial ensemble, then each step's perturbed observations and process
  noise), and the solutions agree within rtol 1e-9 (x, xt, R, Rt, ll).
- Statistical, as the JAX test makes it: the EnKF's states within 1.3
  times the KF's RMS error and its ll within 10 % of the KF's (N = 2000).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import np_of

import lowlevelparticlefilters_jl_tpu as llpf
import lowlevelparticlefilters_jl_tpu_torch as llpt
from lowlevelparticlefilters_jl_tpu_torch import convert
from lowlevelparticlefilters_jl_tpu_torch.filters import enkf as fe

A = np.array([[0.9, 0.1], [0.0, 0.95]])
B = np.array([[0.0], [1.0]])
C = np.array([[1.0, 0.0]])
R1 = 0.01 * np.eye(2)
R2 = 0.1 * np.eye(1)
TOL = dict(rtol=1e-9, atol=1e-12)


def _callbacks(xp, dtype):
    Am, Bm, Cm = (xp.asarray(M, dtype=dtype) for M in (A, B, C))
    return (lambda x, u, p, t: Am @ x + Bm @ u,
            lambda x, u, p, t: Cm @ x)


def _jax_enkf(N, inflation=1.0):
    return llpf.EnsembleKalmanFilter(
        *_callbacks(jnp, jnp.float64), R1=jnp.asarray(R1),
        R2=jnp.asarray(R2), d0=llpf.MvNormal(jnp.zeros(2), jnp.eye(2)),
        N=N, nu=1, inflation=inflation)


def _port_enkf(N, inflation=1.0):
    return convert.enkf_from_numpy(N, *_callbacks(torch, torch.float64), R1,
                                   R2, None, np.eye(2), inflation=inflation,
                                   nu=1, device="cpu")


def _jax_draws(fj, key, T):
    """The JAX EnKF's draws in the order the port makes them: the initial
    ensemble, then each step's perturbed observations (correct) and
    process noise (predict), each from the key split as JAX splits it."""
    N = fj.N
    key, k0 = jax.random.split(key)
    out = [fj.d0.sample(k0, (N,))]
    for _ in range(T):
        key, ke = jax.random.split(key)
        out.append(llpf.as_mvnormal(fj.R2).sample(ke, (N,)))
        key, kw = jax.random.split(key)
        out.append(llpf.as_mvnormal(fj.R1).sample(kw, (N,)))
    return [torch.tensor(np.asarray(d)) for d in out]


def _data(T, seed=0):
    rng = np.random.default_rng(seed)
    return 0.5 * np.sin(np.arange(T))[:, None], rng.normal(size=(T, 1))


@pytest.mark.parametrize("inflation", [1.0, 1.1])
def test_enkf_draw_for_draw_matches_jax(monkeypatch, inflation):
    N, T = 64, 20
    u, y = _data(T)
    fj, ft = _jax_enkf(N, inflation), _port_enkf(N, inflation)
    key = jax.random.PRNGKey(1)
    draws = _jax_draws(fj, key, T)
    monkeypatch.setattr(fe, "_sample", lambda d, g, n: draws.pop(0))
    sj = fj.forward_trajectory(jnp.asarray(u), jnp.asarray(y), key=key)
    st = llpt.forward_trajectory(ft, torch.tensor(u), torch.tensor(y),
                                 generator=torch.Generator().manual_seed(0))
    assert not draws and st.route == "sequential"
    for f in ("x", "xt", "R", "Rt", "ll", "e", "K", "S"):
        np.testing.assert_allclose(np_of(getattr(st, f)),
                                   np_of(getattr(sj, f)), err_msg=f, **TOL)


def test_enkf_near_kf_oracle():
    """EnKF ≈ KF on the linear system (tests/test_advanced_filters.py's
    oracle check, N = 2000, T = 80); ``loglik`` through the verb, which
    calls the EnKF's own ``loglik`` without ``method``."""
    T = 80
    kf = convert.kalman_filter_from_numpy(A, B, C, 0, R1, R2, None,
                                          np.eye(2), device="cpu")
    us = torch.tensor(0.5 * np.sin(np.arange(T))[:, None])
    xs, _, ys = llpt.simulate(kf, us, torch.Generator().manual_seed(0))
    sol_kf = llpt.forward_trajectory(kf, us, ys)
    enkf = _port_enkf(2000)
    sol_en = llpt.forward_trajectory(
        enkf, us, ys, generator=torch.Generator().manual_seed(1))
    err_kf = float(torch.sqrt(torch.mean((sol_kf.xt - xs) ** 2)))
    err_en = float(torch.sqrt(torch.mean((sol_en.xt - xs) ** 2)))
    assert err_en < 1.3 * err_kf, (err_en, err_kf)
    ll = llpt.loglik(enkf, us, ys, generator=torch.Generator().manual_seed(1))
    assert llpt.last_route("loglik") == "sequential"
    assert float(ll) == float(sol_en.ll)
    assert abs(float(ll) - float(sol_kf.ll)) < 0.1 * abs(float(sol_kf.ll))
    with pytest.raises(ValueError, match="generator"):
        enkf.forward_trajectory(us, ys)


def test_enkf_ensemble_stats_and_convert():
    """``ensemble_mean``/``ensemble_cov`` against numpy and the JAX
    package; ``convert.enkf_from_numpy`` builds the filter the direct
    constructor builds; inflation widens the predicted spread."""
    X = np.random.default_rng(0).normal(size=(500, 3)) @ np.array(
        [[2.0, 0, 0], [0.5, 1.0, 0], [0, 0, 0.1]])
    Xt = torch.tensor(X)
    np.testing.assert_allclose(np_of(llpt.ensemble_mean(Xt)), X.mean(0),
                               rtol=1e-12)
    np.testing.assert_allclose(np_of(llpt.ensemble_cov(Xt)), np.cov(X.T),
                               rtol=1e-12)
    np.testing.assert_allclose(
        np_of(llpt.ensemble_cov(Xt)),
        np_of(llpf.ensemble_cov(jnp.asarray(X))), rtol=1e-12)
    ft = _port_enkf(500)
    direct = llpt.EnsembleKalmanFilter(
        *_callbacks(torch, torch.float64), R1=torch.tensor(R1),
        R2=torch.tensor(R2),
        d0=llpt.MvNormal(torch.zeros(2, dtype=torch.float64),
                         torch.eye(2, dtype=torch.float64)), N=500, nu=1)
    for name in ("R1", "R2"):
        assert torch.equal(getattr(ft, name), getattr(direct, name))
    assert torch.equal(ft.d0.cov, direct.d0.cov)
    assert (ft.nx, ft.ny, ft.N) == (2, 1, 500)
    s = ft.init(torch.Generator().manual_seed(2))
    spread = [torch.trace(llpt.ensemble_cov(
        f.predict(s, torch.zeros(1, dtype=torch.float64)).X))
        for f in (ft, ft.replace(inflation=1.2))]
    assert float(spread[1]) > float(spread[0])
