"""PyTorch port: ``utils/diagnostics.py`` against the JAX package on the
same numpy inputs in float64, rtol 1e-10.

- ``validation_stats`` of the KF solution on the benchmark's model
  (every key: RMS, NIS and its bounds, autocorrelation, the
  innovation-input cross-correlation [maxlag, nu, ny]);
- ``autocor``/``crosscor`` (one batched product in the port, a loop of
  reductions in JAX), ``innovation_rms``, ``compute_nis``;
- ``kde`` with and without weights; arrays go to the device of the
  tensors among the inputs, else to the card (without one that raises);
- ``diagnose_solution`` of a healthy solution and of one made to fail at
  step 4 (an indefinite R2 at that step), as
  tests/test_diagnostics.py::TestConstructorChecksAndDiagnosis does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import A, B, C, R1, R2, np_of

import lowlevelparticlefilters_jl_tpu as llpf
import lowlevelparticlefilters_jl_tpu_torch as llpt
from lowlevelparticlefilters_jl_tpu_torch import convert

T = 80  # maxlag min(50, T // 4) = 20
RTOL = dict(rtol=1e-10, atol=1e-12)


def _data(T=T, seed=0):
    rng = np.random.default_rng(seed)
    u = 0.3 + 0.5 * rng.normal(size=(T, 1))
    x, y = np.zeros(2), np.empty((T, 2))
    for k in range(T):
        y[k] = C @ x + rng.multivariate_normal(np.zeros(2), R2)
        x = A @ x + B @ u[k] + rng.multivariate_normal(np.zeros(2), R1)
    return u, y


def _kfs():
    kj = llpf.KalmanFilter(*(jnp.asarray(M) for M in (A, B, C)), 0,
                           jnp.asarray(R1), jnp.asarray(R2))
    kt = convert.kalman_filter_from_numpy(A, B, C, 0, R1, R2, device="cpu")
    return kj, kt


@pytest.fixture(scope="module")
def sols():
    u, y = _data()
    kj, kt = _kfs()
    sj = jax.jit(lambda u, y: llpf.forward_trajectory(kj, u, y))(
        jnp.asarray(u), jnp.asarray(y))
    st = llpt.forward_trajectory(kt, torch.tensor(u), torch.tensor(y))
    return sj, st


@pytest.mark.parametrize("maxlag", [None, 7])
def test_validation_stats_match_jax(sols, maxlag):
    sj, st = sols
    want = jax.jit(lambda s: llpf.validation_stats(s, maxlag=maxlag))(sj)
    got = llpt.validation_stats(st, maxlag=maxlag)
    assert set(got) == set(want)
    assert got["crosscorrelation"].shape == (got["maxlag"], 1, 2)
    for k, w in want.items():
        if k in ("maxlag", "whiteness_bound", "nis_bounds"):
            assert not isinstance(got[k], torch.Tensor), k
        else:
            assert isinstance(got[k], torch.Tensor), k
        np.testing.assert_allclose(np_of(got[k]), np_of(w), **RTOL,
                                   err_msg=k)


def test_correlations_nis_rms_match_jax(sols):
    sj, st = sols
    rng = np.random.default_rng(3)
    x, y = rng.normal(size=120), rng.normal(size=120).cumsum()
    # JAX's loops run under jit: eagerly each lag's slice compiles apart
    auto = jax.jit(llpf.autocor, static_argnums=1)
    cross = jax.jit(llpf.crosscor, static_argnums=2)
    for lag in (0, 1, 30):
        np.testing.assert_allclose(
            np_of(llpt.autocor(torch.tensor(x), lag)),
            np_of(auto(jnp.asarray(x), lag)), **RTOL)
    for lag in (1, 30):
        np.testing.assert_allclose(
            np_of(llpt.crosscor(torch.tensor(x), torch.tensor(y), lag)),
            np_of(cross(jnp.asarray(x), jnp.asarray(y), lag)), **RTOL)
    np.testing.assert_allclose(np_of(llpt.innovation_rms(st.e)),
                               np_of(llpf.innovation_rms(sj.e)), **RTOL)
    np.testing.assert_allclose(np_of(llpt.compute_nis(st.e, st.S)),
                               np_of(llpf.compute_nis(sj.e, sj.S)), **RTOL)
    assert llpt.nis_bounds(3, 0.9) == llpf.nis_bounds(3, 0.9)


@pytest.mark.parametrize("weighted", [False, True])
def test_kde_matches_jax(weighted):
    rng = np.random.default_rng(4)
    x = rng.standard_t(3, size=500)
    we = None
    if weighted:
        we = np.exp(rng.normal(size=500))
        we /= we.sum()
    gj, dj = jax.jit(llpf.kde, static_argnums=2)(
        jnp.asarray(x), None if we is None else jnp.asarray(we), 64)
    gt, dt = llpt.kde(torch.tensor(x), None if we is None
                      else torch.tensor(we), npoints=64)
    np.testing.assert_allclose(np_of(gt), np_of(gj), **RTOL)
    np.testing.assert_allclose(np_of(dt), np_of(dj), **RTOL)


def test_array_inputs_take_the_tensors_device_or_the_card():
    rng = np.random.default_rng(5)
    x, we = rng.normal(size=50), np.full(50, 1 / 50)
    grid, dens = llpt.kde(x, torch.tensor(we))
    assert grid.device.type == "cpu" and dens.dtype == torch.float64
    if not torch.cuda.is_available():
        for call in (lambda: llpt.kde(x), lambda: llpt.autocor(x, 5),
                     lambda: llpt.crosscor(x, x, 5)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()


def test_diagnose_solution_matches_jax():
    """The step and the reason of a failure, the same dict for a healthy
    solution."""
    Tn = 10
    us = np.zeros((Tn, 1))
    ys = np.random.default_rng(0).normal(size=(Tn, 2))
    kj = llpf.KalmanFilter(0.9 * jnp.eye(2), jnp.zeros((2, 1)), jnp.eye(2),
                           0, jnp.eye(2), jnp.eye(2))
    kt = convert.kalman_filter_from_numpy(0.9 * np.eye(2), np.zeros((2, 1)),
                                          np.eye(2), 0, np.eye(2), np.eye(2),
                                          device="cpu")
    bad_j = lambda f, st, u, y, p, t: jnp.where(  # noqa: E731
        jnp.isclose(t, 4.0), -10.0 * jnp.eye(2), jnp.eye(2))
    bad_t = lambda f, st, u, y, p, t: (  # noqa: E731
        -10.0 if t == 4 else 1.0) * torch.eye(2, dtype=torch.float64)
    sj = jax.jit(lambda u, y: llpf.forward_trajectory(
        kj, u, y, pre_correct_cb=bad_j))(jnp.asarray(us), jnp.asarray(ys))
    st = llpt.forward_trajectory(kt, torch.tensor(us), torch.tensor(ys),
                                 pre_correct_cb=bad_t)
    want, got = llpf.diagnose_solution(sj), llpt.diagnose_solution(st)
    assert got["ok"] is False and got["first_bad_step"] == 4
    assert set(got) == set(want) and got["reason"] == want["reason"]
    for k in ("S", "S_eigenvalues", "e"):
        if k in want:
            np.testing.assert_allclose(got[k], np.asarray(want[k]), **RTOL,
                                       err_msg=k)
    ok_j = jax.jit(lambda u, y: llpf.forward_trajectory(kj, u, y))(
        jnp.asarray(us), jnp.asarray(ys))
    ok_t = llpt.forward_trajectory(kt, torch.tensor(us), torch.tensor(ys))
    assert llpt.diagnose_solution(ok_t) == llpf.diagnose_solution(ok_j) \
        == {"ok": True}
