"""PyTorch port: ``ukf_bank_loglik`` / ``ekf_bank_loglik`` against the JAX
package at B = 8, T = 50 in float64, rtol 1e-10: the affine reroute (the
callbacks' Jacobians and offsets folded into an augmented input column,
then ``kf_bank_loglik``'s plane path on the CPU) and the ``vmap(loglik)``
fallback for anything the static walk cannot prove affine."""
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import A, B, C, R1, R2, np_of

import lowlevelparticlefilters_jl_tpu as llpf
import lowlevelparticlefilters_jl_tpu_torch as llpt

BK, T = 8, 50
RTOL = dict(rtol=1e-10, atol=1e-12)
D0M, D0C = np.array([0.2, -0.1]), 0.5 * np.eye(2)
OFF_C, OFF_D = np.array([0.05, -0.02]), np.array([0.1, 0.0])


def _callbacks(xp, kind):
    """(dynamics, measurement) in ``xp`` (jnp or torch)."""
    t_ = (lambda a: xp.asarray(a)) if xp is jnp else (
        lambda a: torch.tensor(a, dtype=torch.float64))
    At, Bt, Ct, c, d = (t_(M) for M in (A, B, C, OFF_C, OFF_D))
    s = t_(1.01)  # a tensor the callbacks close over
    if kind == "linear":
        return (lambda x, u, p, t: At @ x + Bt @ u,
                lambda x, u, p, t: Ct @ x)
    if kind == "affine_offsets":
        return (lambda x, u, p, t: s * (At @ x) + Bt @ u + c,
                lambda x, u, p, t: Ct @ x + d)
    if kind == "sin":
        return (lambda x, u, p, t: At @ x + Bt @ u + 0.05 * xp.sin(x),
                lambda x, u, p, t: Ct @ x)
    # a branch on the state: affine on each side, not as a whole
    return (lambda x, u, p, t: At @ x + Bt @ u,
            lambda x, u, p, t: xp.where(x > 0, Ct @ x, 0.5 * (Ct @ x)))


def _filters(family, kind):
    (fj, gj), (ft, gt) = _callbacks(jnp, kind), _callbacks(torch, kind)
    make_j, make_t = {"ukf": (llpf.make_ukf, llpt.make_ukf),
                      "ekf": (llpf.make_ekf, llpt.make_ekf)}[family]
    dj = llpf.MvNormal(jnp.asarray(D0M), jnp.asarray(D0C))
    dt = llpt.MvNormal(torch.tensor(D0M), torch.tensor(D0C))
    kj = make_j(fj, gj, jnp.asarray(R1), jnp.asarray(R2), dj, nu=1, ny=2)
    kt = make_t(ft, gt, torch.tensor(R1), torch.tensor(R2), dt, nu=1, ny=2)
    return kj, kt


CASES = [("ukf", "linear", "bank_plane"),
         ("ekf", "affine_offsets", "bank_plane"),
         ("ukf", "sin", "bank_vmap"),
         ("ekf", "branch", "bank_vmap")]


def _case_data(kind):
    rng = np.random.default_rng(len(kind))
    return 0.3 + 0.1 * rng.normal(size=(BK, T, 1)), rng.normal(
        size=(BK, T, 2))


def _shared_data():
    rng = np.random.default_rng(9)
    return 0.3 + 0.1 * rng.normal(size=(T, 1)), rng.normal(size=(BK, T, 2))


def _jax_bank(family, kind, shared=False):
    us, ys = _shared_data() if shared else _case_data(kind)
    kj, _ = _filters(family, kind)
    fn = llpf.ukf_bank_loglik if family == "ukf" else llpf.ekf_bank_loglik
    return np_of(fn(kj, jnp.asarray(us), jnp.asarray(ys)))


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX package's bank lls, one future each, computed in a thread
    while the port's run (most of their time is XLA compiling, which
    releases the interpreter lock); the thread has ended when the module
    does."""
    with ThreadPoolExecutor(max_workers=1) as pool:
        refs = {kind: pool.submit(_jax_bank, family, kind)
                for family, kind, _ in CASES}
        refs["shared"] = pool.submit(_jax_bank, "ukf", "linear", True)
        yield refs


@pytest.mark.parametrize("family,kind,route", CASES)
def test_ukf_bank_loglik_matches_jax(jax_refs, family, kind, route):
    us, ys = _case_data(kind)
    _, kt = _filters(family, kind)
    fn_t = llpt.ukf_bank_loglik if family == "ukf" else llpt.ekf_bank_loglik
    got = fn_t(kt, torch.tensor(us), torch.tensor(ys))
    assert llpt.last_route("ukf_bank_loglik") == route
    # every member is the filter's own sequential ll
    seq = llpt.loglik(kt, torch.tensor(us[1]), torch.tensor(ys[1]),
                      method="sequential")
    np.testing.assert_allclose(float(got[1]), float(seq), rtol=1e-9)
    np.testing.assert_allclose(np_of(got), jax_refs[kind].result(), **RTOL)


def test_ukf_bank_shared_inputs_equal_the_kf_bank(jax_refs):
    """A shared ``[T, nu]`` input; the affine reroute of a linear UKF gives
    the lls of ``kf_bank_loglik`` on the equivalent KF."""
    u, ys = _shared_data()
    _, kt = _filters("ukf", "linear")
    got = llpt.ukf_bank_loglik(kt, torch.tensor(u), torch.tensor(ys))
    kf = llpt.KalmanFilter(torch.tensor(A), torch.tensor(B), torch.tensor(C),
                           0, torch.tensor(R1), torch.tensor(R2),
                           d0=kt.d0)
    np.testing.assert_allclose(
        np_of(got), np_of(llpt.kf_bank_loglik(kf, torch.tensor(u),
                                              torch.tensor(ys))), rtol=1e-9)
    np.testing.assert_allclose(np_of(got), jax_refs["shared"].result(),
                               **RTOL)
