"""PyTorch port: the Interacting Multiple Models filter (filters/imm.py)
against the JAX package, in float64 on the same numpy inputs.

- Deterministic, rtol 1e-9 (atol 1e-12): ``forward_trajectory``'s
  combined moments (x, xt, R, Rt), ll and mode probabilities
  (``sol.extra``) on the banks of tests/test_advanced_filters.py (two
  identical KFs, a garbage mode, the asymmetric P, a KF and a UKF) and
  on examples/example_beetle_imm.py's two augmented-dynamics UKFs.
- The gradient of ``loglik`` by autograd against ``jax.grad`` on the
  sticky model of tests/test_advanced_filters.py (a terminal mode), rtol
  1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import (BEETLE_P, beetle_dynamics, beetle_imm,
                           beetle_params, beetle_track, np_of)

import lowlevelparticlefilters_jl_tpu as llpf
import lowlevelparticlefilters_jl_tpu_torch as llpt
from lowlevelparticlefilters_jl_tpu_torch import convert

A = np.array([[0.99, 0.1], [0.0, 0.2]])
B = np.array([[-0.74, 1.61], [-1.44, 1.75]])
C = np.eye(2)
I2 = np.eye(2)
T = 30
TOL = dict(rtol=1e-9, atol=1e-12)
BANKS = {"identical": ([[0.5, 0.5], [0.5, 0.5]], False, 1.0),
         "garbage": ([[0.5, 0.5], [0.5, 0.5]], False, 1e4),
         "stationary": ([[0.5, 0.5], [1.0, 0.0]], False, 1.0),
         "kf_ukf": ([[0.5, 0.5], [0.5, 0.5]], True, 1.0)}


def _data(seed):
    """A draw of the first mode's KF: ``(u [T, 2], y [T, 2])``."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(T, 2))
    x, ys = np.zeros(2), []
    for k in range(T):
        ys.append(C @ x + rng.normal(size=2))
        x = A @ x + B @ u[k] + rng.normal(size=2)
    return u, np.array(ys)


def _banks(which):
    P, ukf, scale = BANKS[which]
    d0j = llpf.MvNormal(jnp.zeros(2), jnp.eye(2))
    kj = llpf.KalmanFilter(A, B, C, 0, I2, I2, d0=d0j)
    kt = convert.kalman_filter_from_numpy(A, B, C, 0, I2, I2, None, I2,
                                          device="cpu")
    if ukf:
        Aj, Bj = jnp.asarray(A), jnp.asarray(B)
        At, Bt = torch.tensor(A), torch.tensor(B)
        mj = llpf.make_ukf(lambda x, u, p, t: Aj @ x + Bj @ u,
                           lambda x, u, p, t: x, I2, I2, d0=d0j, nu=2, ny=2)
        mt = convert.ukf_from_numpy(lambda x, u, p, t: At @ x + Bt @ u,
                                    lambda x, u, p, t: x, I2, I2, None, I2,
                                    nu=2, dtype=torch.float64, device="cpu")
    else:
        mj = llpf.KalmanFilter(scale * A, B, C, 0, I2,
                               (100.0 if scale > 1 else 1.0) * I2, d0=d0j)
        mt = convert.kalman_filter_from_numpy(
            scale * A, B, C, 0, I2, (100.0 if scale > 1 else 1.0) * I2,
            None, I2, device="cpu")
    return (llpf.IMM([kj, mj], jnp.asarray(P), jnp.array([0.5, 0.5])),
            convert.imm_from_numpy([kt, mt], P, [0.5, 0.5], device="cpu"))


def _check(st, sj):
    for f in ("x", "xt", "R", "Rt", "ll", "extra"):
        np.testing.assert_allclose(np_of(getattr(st, f)),
                                   np_of(getattr(sj, f)), err_msg=f, **TOL)
    assert st.e is None and sj.e is None and st.route == "sequential"


@pytest.mark.parametrize("which", list(BANKS))
def test_imm_forward_trajectory_matches_jax(which):
    u, y = _data(list(BANKS).index(which))
    ij, it = _banks(which)
    sj = llpf.forward_trajectory(ij, jnp.asarray(u), jnp.asarray(y))
    st = llpt.forward_trajectory(it, torch.tensor(u), torch.tensor(y))
    _check(st, sj)
    mus = np_of(st.extra)
    np.testing.assert_allclose(mus.sum(-1), 1.0, atol=1e-12)
    if which == "garbage":
        assert np.all(mus[2:, 0] > 0.95)
    ll = llpt.loglik(it, torch.tensor(u), torch.tensor(y))
    assert llpt.last_route("loglik") == "sequential"
    assert float(ll) == float(st.ll)


def test_beetle_imm_matches_jax():
    """The example's IMM of two augmented-dynamics UKFs (T = 40, the mode
    switch at 20)."""
    xs, ys = beetle_track(40, seed=3)
    th = beetle_params()
    d0j = llpf.MvNormal(jnp.concatenate([jnp.asarray(ys[0]),
                                         jnp.array([0.5, 0.3])]),
                        jnp.diag(jnp.array([3.0, 3.0, 2.0, 2.0])))
    R1 = jnp.diag(10.0 ** jnp.asarray(th[:4]))
    R2 = 10.0 ** th[4] * 0.01 * jnp.eye(2)
    modes = tuple(llpf.make_ukf(beetle_dynamics(m, jnp),
                                lambda x, u, p, t: x[:2], R1, R2, d0=d0j,
                                nu=0, ny=2, nw=4, augmented_dynamics=True,
                                p=2.0 + 10.0 ** th[5]) for m in (0.0, 1.0))
    ij = llpf.IMM(modes, jnp.asarray(BEETLE_P), jnp.array([1.0, 0.0]))
    it = beetle_imm(torch.tensor(th), ys[0])
    u = np.zeros((40, 0))
    _check(llpt.forward_trajectory(it, torch.tensor(u), torch.tensor(ys)),
           llpf.forward_trajectory(ij, jnp.asarray(u), jnp.asarray(ys)))


def test_sticky_imm_loglik_gradient_matches_jax():
    """d loglik / d log10 r1 by autograd against ``jax.grad`` on the
    sticky two-mode bank (P[1, 0] = 0, mu0 = [1, 0]), whose dying mode's
    mixing mass decays through the denormals: finite and equal."""
    A2 = np.array([[1.0, 0.1], [0.0, 1.0]])
    ys = np.random.default_rng(0).normal(size=(60, 2)).cumsum(0) * 0.1
    us = np.zeros((60, 0))
    Psticky = [[0.995, 0.005], [0.0, 1.0]]

    def nll_jax(log_r1):
        R1 = (10.0 ** log_r1) * jnp.eye(2)
        d0 = llpf.MvNormal(jnp.zeros(2), jnp.eye(2))
        mk = lambda q: llpf.KalmanFilter(  # noqa: E731
            A2, jnp.zeros((2, 0)), jnp.eye(2), 0, q * R1, 0.1 * jnp.eye(2),
            d0=d0)
        imm = llpf.IMM((mk(1.0), mk(25.0)), jnp.asarray(Psticky),
                       jnp.array([1.0, 0.0]))
        return -llpf.loglik(imm, jnp.asarray(us), jnp.asarray(ys))

    vj, gj = jax.value_and_grad(nll_jax)(jnp.asarray(-1.0))
    lr = torch.tensor(-1.0, dtype=torch.float64, requires_grad=True)
    R1 = (10.0 ** lr) * torch.eye(2, dtype=torch.float64)
    d0 = llpt.MvNormal(torch.zeros(2, dtype=torch.float64),
                       torch.eye(2, dtype=torch.float64))
    mk = lambda q: llpt.KalmanFilter(  # noqa: E731
        torch.tensor(A2), torch.zeros(2, 0, dtype=torch.float64),
        torch.eye(2, dtype=torch.float64), 0, q * R1,
        0.1 * torch.eye(2, dtype=torch.float64), d0=d0)
    imm = llpt.IMM((mk(1.0), mk(25.0)),
                   torch.tensor(Psticky, dtype=torch.float64),
                   torch.tensor([1.0, 0.0], dtype=torch.float64))
    v = -llpt.loglik(imm, torch.tensor(us), torch.tensor(ys))
    v.backward()
    assert np.isfinite(float(lr.grad))
    np.testing.assert_allclose(float(v), float(vj), rtol=1e-9)
    np.testing.assert_allclose(float(lr.grad), float(gj), rtol=1e-6)


def test_imm_steps_and_convert():
    """``interact``/``combine`` and one ``update`` against the JAX package;
    ``convert.imm_from_numpy`` checks P and mu0 as the constructor
    does."""
    u, y = _data(9)
    ij, it = _banks("stationary")
    sj, st = ij.init(), it.init()
    for k in range(3):
        sj, infj = ij.update(sj, jnp.asarray(u[k]), jnp.asarray(y[k]))
        st, inft = it.update(st, torch.tensor(u[k]), torch.tensor(y[k]))
    np.testing.assert_allclose(np_of(st.mu), np_of(sj.mu), **TOL)
    np.testing.assert_allclose(np_of(inft.lls), np_of(infj.lls), **TOL)
    for a, b in zip(llpt.combine(it, st), llpf.combine(ij, sj)):
        np.testing.assert_allclose(np_of(a), np_of(b), **TOL)
    mj, mt = llpf.interact(ij, sj), llpt.interact(it, st)
    for sj_, st_ in zip(mj.states, mt.states):
        np.testing.assert_allclose(np_of(st_.R), np_of(sj_.R), **TOL)
    assert it.n_modes == 2 and it.Ts == 1.0
    with pytest.raises(ValueError, match="rows"):
        convert.imm_from_numpy(it.models, [[0.5, 0.4], [0.5, 0.5]],
                               [0.5, 0.5], device="cpu")
    with pytest.raises(ValueError, match="mu0"):
        convert.imm_from_numpy(it.models, BANKS["identical"][0],
                               [0.5, 0.6], device="cpu")
