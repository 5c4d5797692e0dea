"""PyTorch port: KalmanFilter forward_trajectory and loglik against the
JAX package's sequential scan, float64, rtol 1e-10 (same recursion; only
rounding differs)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import A, B, C, R1, R2, np_of

import lowlevelparticlefilters_jl_tpu as llpf
import lowlevelparticlefilters_jl_tpu_torch as llpt
from lowlevelparticlefilters_jl_tpu_torch import convert
from lowlevelparticlefilters_jl_tpu_torch.ops.matrices import (
    TimeVarying, resolve_mat)

T = 200
RTOL = 1e-10


def _data(seed=0, T=T):
    rng = np.random.default_rng(seed)
    return 0.3 * np.ones((T, 1)) + 0.1 * rng.normal(size=(T, 1)), \
        rng.normal(size=(T, 2))


def _both(A_, alpha=1.0):
    d0m, d0c = np.array([0.5, -0.2]), 2.0 * np.eye(2)
    kj = llpf.KalmanFilter(jnp.asarray(A_), jnp.asarray(B), jnp.asarray(C), 0,
                           jnp.asarray(R1), jnp.asarray(R2),
                           d0=llpf.MvNormal(jnp.asarray(d0m),
                                            jnp.asarray(d0c)),
                           alpha=alpha)
    kt = convert.kalman_filter_from_numpy(A_, B, C, 0, R1, R2, d0m, d0c,
                                          alpha=alpha)
    return kj, kt


def _tv_A():
    th = 0.1 + 0.05 * np.sin(np.arange(T) / 10.0)
    c, s = 0.97 * np.cos(th), 0.97 * np.sin(th)
    return np.stack([np.array([[ci, -si], [si, ci]]) for ci, si in zip(c, s)])


CASES = {"headline": (A, 1.0), "time_varying_A": (_tv_A(), 1.0),
         "alpha": (A, 1.05)}


@pytest.mark.parametrize("case", list(CASES))
def test_forward_trajectory_matches_jax(case):
    A_, alpha = CASES[case]
    kj, kt = _both(A_, alpha)
    u, y = _data()
    sj = llpf.forward_trajectory(kj, jnp.asarray(u), jnp.asarray(y),
                                 method="sequential")
    st = llpt.forward_trajectory(kt, torch.tensor(u), torch.tensor(y))
    for f in ("x", "xt", "R", "Rt", "e", "S", "K", "ll"):
        np.testing.assert_allclose(np_of(getattr(st, f)),
                                   np_of(getattr(sj, f)), rtol=RTOL,
                                   atol=1e-13, err_msg=f)
    assert bool(st.ok.all())
    assert llpt.last_route("forward_trajectory") == "sequential"


@pytest.mark.parametrize("case", list(CASES))
def test_loglik_matches_jax(case):
    A_, alpha = CASES[case]
    kj, kt = _both(A_, alpha)
    u, y = _data(1)
    llj = llpf.loglik(kj, jnp.asarray(u), jnp.asarray(y), method="sequential")
    llt = llpt.loglik(kt, torch.tensor(u), torch.tensor(y))
    np.testing.assert_allclose(float(llt), float(llj), rtol=RTOL)
    assert llpt.last_route() == "sequential"


def test_missing_input_and_default_d0():
    kt = convert.kalman_filter_from_numpy(A, np.zeros((2, 1)), C, None, R1,
                                          R2)
    kj = llpf.KalmanFilter(jnp.asarray(A), jnp.zeros((2, 1)), jnp.asarray(C),
                           0, jnp.asarray(R1), jnp.asarray(R2))
    _, y = _data(2, 40)
    llj = llpf.loglik(kj, None, jnp.asarray(y), method="sequential")
    llt = llpt.loglik(kt, None, torch.tensor(y))
    np.testing.assert_allclose(float(llt), float(llj), rtol=RTOL)


def test_resolve_mat_time_indexing():
    data = torch.arange(12.0).reshape(3, 2, 2)
    assert torch.equal(resolve_mat(data, None, None, None, 2.0), data[2])
    assert torch.equal(resolve_mat(TimeVarying(data), None, None, None, 1.0,
                                   Ts=0.5), data[2])
    with pytest.raises(ValueError):
        resolve_mat(data, None, None, None, 0.5)
    d0 = data[0]
    assert resolve_mat(d0, None, None, None, 7.0) is d0


def test_simulate_shapes_and_generator():
    kt = convert.kalman_filter_from_numpy(A, B, C, 0, R1, R2)
    u = torch.full((30, 1), 0.3, dtype=torch.float64)
    x, u2, y = llpt.simulate(kt, u, torch.Generator().manual_seed(0))
    x2, _, y2 = llpt.simulate(kt, u, torch.Generator().manual_seed(0))
    assert x.shape == (30, 2) and y.shape == (30, 2) and u2 is not None
    assert torch.equal(y, y2) and torch.equal(x, x2)
