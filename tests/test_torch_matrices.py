"""PyTorch port: callable, time-stacked and indexing system matrices (the
KF's sequential and temporal-parallel paths, ``sol.ok``'s
state-independence flag, the gates that refuse callables), the KF's
``correct(mm=)``, and the ops ``symmetrize_psd``, ``positive_qr_r``,
``ops/constraints.py`` and ``ops/discretize.py``, each against the JAX
package on the same numpy inputs in float64.

Tolerances: the recursions and ops repeat the JAX package's algebra, so
they agree to rtol 1e-10 (the temporal-parallel path, whose scan
associates its products differently, to 1e-9); an eigendecomposition or
QR (``symmetrize_psd``, ``positive_qr_r``) to 1e-10 absolute on O(1)
entries."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import A, B, C, R1, R2, np_of

import lowlevelparticlefilters_jl_tpu as llpf
import lowlevelparticlefilters_jl_tpu_torch as llpt
from lowlevelparticlefilters_jl_tpu.ops import constraints as jcons
from lowlevelparticlefilters_jl_tpu.ops import discretize as jdisc
from lowlevelparticlefilters_jl_tpu.ops.linalg import (
    positive_qr_r as j_positive_qr_r, symmetrize_psd as j_symmetrize_psd)
from lowlevelparticlefilters_jl_tpu.ops.matrices import (
    indexing_matrix as j_indexing_matrix, is_constant_mat as j_is_constant)
from lowlevelparticlefilters_jl_tpu.parallel.temporal import (
    _state_indep_flag as j_state_indep_flag)
from lowlevelparticlefilters_jl_tpu_torch import convert, routing
from lowlevelparticlefilters_jl_tpu_torch.parallel.temporal import (
    _state_indep_flag as t_state_indep_flag)
from lowlevelparticlefilters_jl_tpu_torch.filters import bank as tbank

T = 50
RTOL = dict(rtol=1e-10, atol=1e-12)
D0M, D0C = np.array([0.5, -0.2]), 2.0 * np.eye(2)


def _data(seed=0, T=T):
    rng = np.random.default_rng(seed)
    return (0.3 + 0.1 * rng.normal(size=(T, 1)), rng.normal(size=(T, 2)))


def _time(xp, t):
    """``t`` as an array: the sequential loops pass a Python float (the
    port) or a float64 scalar (JAX), the parallel path a batched tensor."""
    return jnp.asarray(t) if xp is jnp else torch.as_tensor(
        t, dtype=torch.float64)


def _tv_A(xp):
    """A time-varying, state-independent callable A in numpy-like ``xp``
    (jnp or torch): the rotation slowly modulated in t."""
    As = xp.asarray(A) if xp is jnp else torch.tensor(A)

    def Af(x, u, p, t):
        return As * (1.0 + 0.02 * xp.cos(0.05 * _time(xp, t)))
    return Af


def _dep_A(xp):
    """A callable A that depends on the state."""
    As = xp.asarray(A) if xp is jnp else torch.tensor(A)

    def Af(x, u, p, t):
        return As * (1.0 + 0.02 * xp.tanh(x[0]))
    return Af


def _tv_R2(xp):
    """A callable R2 that depends on the input only."""
    Rs = xp.asarray(R2) if xp is jnp else torch.tensor(R2)

    def Rf(x, u, p, t):
        return Rs * (1.0 + 0.5 * u[0] ** 2)
    return Rf


def _stacked_A():
    th = 0.1 + 0.05 * np.sin(np.arange(T) / 10.0)
    c, s = 0.97 * np.cos(th), 0.97 * np.sin(th)
    return np.stack([np.array([[ci, -si], [si, ci]]) for ci, si in zip(c, s)])


def _kf_pair(A_j, A_t, C_j=None, C_t=None, R2_j=None, R2_t=None, R2n=R2):
    """The same KF in both packages; ``*_j`` / ``*_t`` are each package's
    callable or matrix (numpy arrays serve both)."""
    kj = llpf.KalmanFilter(
        A_j, jnp.asarray(B), C_j if C_j is not None else jnp.asarray(C), 0,
        jnp.asarray(R1), R2_j if R2_j is not None else jnp.asarray(R2n),
        d0=llpf.MvNormal(jnp.asarray(D0M), jnp.asarray(D0C)))
    kt = convert.kalman_filter_from_numpy(
        A_t, B, C_t if C_t is not None else C, 0, R1,
        R2_t if R2_t is not None else R2n, D0M, D0C, device="cpu")
    return kj, kt


CASES = {
    "callable_A": lambda: _kf_pair(_tv_A(jnp), _tv_A(torch)),
    "callable_R2": lambda: _kf_pair(jnp.asarray(A), A, R2_j=_tv_R2(jnp),
                                    R2_t=_tv_R2(torch)),
    "stacked_A": lambda: _kf_pair(jnp.asarray(_stacked_A()), _stacked_A()),
    "indexing_C": lambda: _kf_pair(
        jnp.asarray(A), A, C_j=j_indexing_matrix([1], 2),
        C_t=j_indexing_matrix([1], 2), R2n=R2[:1, :1]),
}


def _y_for(case, y):
    return y[:, 1:] if case == "indexing_C" else y


@pytest.mark.parametrize("case", list(CASES))
def test_kf_matrix_forms_match_jax(case):
    """Sequential ``forward_trajectory`` with callable, time-stacked and
    indexing matrices; the parallel path on the port against the JAX
    package's, with the same ``ok`` flags."""
    kj, kt = CASES[case]()
    u, y = _data(1)
    y = _y_for(case, y)
    sj = llpf.forward_trajectory(kj, jnp.asarray(u), jnp.asarray(y),
                                 method="sequential")
    st = llpt.forward_trajectory(kt, torch.tensor(u), torch.tensor(y))
    for f in ("x", "xt", "R", "Rt", "e", "S", "K", "ll"):
        np.testing.assert_allclose(np_of(getattr(st, f)),
                                   np_of(getattr(sj, f)), err_msg=f, **RTOL)
    # the parallel path against the JAX package's sequential solution (its
    # own parallel path gives the same to 1e-9, and takes no indexing
    # matrix)
    pt = llpt.forward_trajectory(kt, torch.tensor(u), torch.tensor(y),
                                 method="parallel")
    assert pt.route == "temporal_parallel_plain"
    for f in ("xt", "Rt", "ll"):
        np.testing.assert_allclose(np_of(getattr(pt, f)),
                                   np_of(getattr(sj, f)), err_msg=f,
                                   rtol=1e-9, atol=1e-11)
    assert bool(pt.ok.all())


def test_state_dependent_callable_flagged_in_ok():
    """The state-independence flag of each callable equals the JAX
    package's (its ``_state_indep_flag``, which its parallel path ANDs
    into ``sol.ok``); the port's parallel solution of a state-dependent
    callable A is flagged false at every step; its ``loglik`` takes no
    kernel route and no parallel pass: the sequential recursion, as the
    JAX package's."""
    x0, u0 = np.array([0.3, -0.7]), np.array([0.4])
    for make, want in ((_tv_A, True), (_dep_A, False), (_tv_R2, True)):
        fj = j_state_indep_flag(make(jnp), jnp.asarray(x0), jnp.asarray(u0),
                                None, jnp.asarray(0.5))
        ft = t_state_indep_flag(llpt.FnMat(make(torch)), torch.tensor(x0),
                                torch.tensor(u0), None, 0.5)
        assert bool(ft) == bool(fj) == want
    assert t_state_indep_flag(torch.tensor(A), torch.tensor(x0), None, None,
                              0.5) is None
    kj, kt = _kf_pair(_dep_A(jnp), _dep_A(torch))
    u, y = _data(2)
    pt = llpt.forward_trajectory(kt, torch.tensor(u), torch.tensor(y),
                                 method="parallel")
    assert not bool(pt.ok.any())
    for method in ("parallel", "fused", "auto"):
        ll = llpt.loglik(kt, torch.tensor(u), torch.tensor(y), method=method)
        assert llpt.last_route() == "sequential"
    llj = llpf.loglik(kj, jnp.asarray(u), jnp.asarray(y), method="parallel")
    assert llpf.last_route() == "xla_scan"
    np.testing.assert_allclose(float(ll), float(llj), **RTOL)
    # the state-independent one: the solution verb takes the parallel path,
    # the scalar verb refuses it
    kt2 = CASES["callable_A"]()[1]
    assert not routing._kf_parallel_ok(kt2, T, need_arrays=True)
    assert routing._kf_parallel_ok(kt2, T, need_arrays=False)
    assert routing._kf_parallel_ok(kt2.replace(A=torch.tensor(A)), T,
                                   need_arrays=True)
    sm = llpt.smooth(kt2, torch.tensor(u), torch.tensor(y), method="parallel")
    assert sm.sol.route == "temporal_parallel_plain" and bool(sm.sol.ok.all())


def test_callable_matrices_refused_by_the_bank_and_kernel_h():
    """``kf_bank_admissible`` refuses a callable matrix, as the JAX
    package's does; the bank then takes ``vmap(loglik)``; the whole-scan
    delegate (kernel H's gate) refuses it, and an indexing matrix is
    densified by the bank."""
    kj, kt = CASES["callable_A"]()
    assert not tbank.kf_bank_admissible(kt)
    assert not llpf.kf_bank_admissible(kj)
    assert kt._fused_delegate() is None
    rng = np.random.default_rng(3)
    us, ys = 0.3 + 0.1 * rng.normal(size=(3, 30, 1)), rng.normal(
        size=(3, 30, 2))
    llt = llpt.kf_bank_loglik(kt, torch.tensor(us), torch.tensor(ys))
    assert llpt.last_route("kf_bank_loglik") == "bank_vmap"
    llj = llpf.kf_bank_loglik(kj, jnp.asarray(us), jnp.asarray(ys))
    np.testing.assert_allclose(np_of(llt), np_of(llj), **RTOL)
    _, ki = CASES["indexing_C"]()
    kd = ki.replace(C=torch.tensor([[0.0, 1.0]]))
    assert tbank.kf_bank_admissible(ki)
    np.testing.assert_allclose(
        np_of(llpt.kf_bank_loglik(ki, torch.tensor(us), torch.tensor(
            ys[..., 1:]))),
        np_of(llpt.kf_bank_loglik(kd, torch.tensor(us), torch.tensor(
            ys[..., 1:]))), **RTOL)


def test_indexing_matrix_ops_match_jax():
    rng = np.random.default_rng(4)
    inds, n = [2, 0, 2], 4
    Ij, It = j_indexing_matrix(inds, n), llpt.indexing_matrix(inds, n)
    v, M = rng.normal(size=(n, 3)), rng.normal(size=(5, n))
    w, W = rng.normal(size=(3, 2)), rng.normal(size=(5, 3))
    pairs = [
        (It @ torch.tensor(v), Ij @ jnp.asarray(v)),
        (It.matvec(torch.tensor(v)), Ij.matvec(jnp.asarray(v))),
        (It.rmatvec(torch.tensor(w)), Ij.rmatvec(jnp.asarray(w))),
        (It.T @ torch.tensor(w), Ij.T @ jnp.asarray(w)),
        (torch.tensor(M) @ It.T, jnp.asarray(M) @ Ij.T),
        (torch.tensor(W) @ It, jnp.asarray(W) @ Ij),
        (It.todense(torch.float64), Ij.todense(jnp.float64)),
        (It.T.todense(torch.float64), Ij.T.todense(jnp.float64)),
    ]
    for got, want in pairs:
        np.testing.assert_array_equal(np_of(got), np_of(want))
    assert It.shape == Ij.shape and It.T.shape == Ij.T.shape
    assert It.T.T is It


def test_matspec_helpers_match_jax():
    fn = lambda x, u, p, t: x  # noqa: E731
    specs = [None, np.eye(2), np.ones((5, 2, 2)), fn,
             llpt.TimeVarying(torch.ones(5, 2, 2))]
    jspecs = [None, jnp.eye(2), jnp.ones((5, 2, 2)), fn,
              llpf.TimeVarying(jnp.ones((5, 2, 2)))]
    for s, sj in zip(specs, jspecs):
        st = llpt.FnMat(s) if callable(s) and not isinstance(
            s, llpt.TimeVarying) else s
        assert llpt.is_constant_mat(st) == j_is_constant(sj)
    assert llpt.is_constant_mat(llpt.indexing_matrix([0], 2))
    from lowlevelparticlefilters_jl_tpu_torch.ops.matrices import as_matspec
    wrapped = as_matspec(fn)
    assert isinstance(wrapped, llpt.FnMat) and as_matspec(wrapped) is wrapped
    x = torch.tensor([1.0, 2.0])
    assert torch.equal(llpt.resolve_mat(wrapped, x, None, None, 0.0), x)


def test_kf_correct_mm_matches_jax():
    """``KalmanFilter.correct(..., mm=)`` takes the model's C, D, R2."""
    kj, kt = _kf_pair(jnp.asarray(A), A)
    Cm, R2m = np.array([[1.0, 0.5]]), np.array([[0.3]])
    mj = llpf.LinearMeasurementModel(jnp.asarray(Cm), None, jnp.asarray(R2m))
    mt = llpt.LinearMeasurementModel(torch.tensor(Cm), None,
                                     torch.tensor(R2m))
    y1 = np.array([0.4])
    sj, ij = kj.correct(kj.init(), jnp.zeros(1), jnp.asarray(y1), mm=mj)
    st, it = kt.correct(kt.init(), torch.zeros(1), torch.tensor(y1), mm=mt)
    for a, b in ((st.x, sj.x), (st.R, sj.R), (it.ll, ij.ll), (it.K, ij.K)):
        np.testing.assert_allclose(np_of(a), np_of(b), **RTOL)
    u, y = _data(5)
    fj = llpf.forward_trajectory(kj, jnp.asarray(u), jnp.asarray(y[:, :1]),
                                 mm=mj)
    ft = llpt.forward_trajectory(kt, torch.tensor(u), torch.tensor(
        y[:, :1]), mm=mt)
    assert ft.route == "sequential"
    np.testing.assert_allclose(np_of(ft.xt), np_of(fj.xt), **RTOL)
    np.testing.assert_allclose(float(ft.ll), float(fj.ll), **RTOL)


def test_linalg_helpers_match_jax():
    rng = np.random.default_rng(6)
    X = rng.normal(size=(3, 4, 4))
    S = X @ np.swapaxes(X, -1, -2) - 0.5 * np.eye(4)  # some eigenvalues < 0
    np.testing.assert_allclose(
        np_of(llpt.symmetrize_psd(torch.tensor(S), eps=1e-9)),
        np_of(j_symmetrize_psd(jnp.asarray(S), eps=1e-9)), atol=1e-10)
    Z = rng.normal(size=(2, 6, 3))
    Rt = llpt.positive_qr_r(torch.tensor(Z))
    np.testing.assert_allclose(np_of(Rt), np_of(j_positive_qr_r(
        jnp.asarray(Z))), atol=1e-10)
    assert bool((torch.diagonal(Rt, dim1=-2, dim2=-1) > 0).all())


CONSTRAINT_CASES = [
    # (m, s, a, b): two-sided, one-sided each way, collapsed, empty mass
    (0.3, 1.0, -0.5, 1.0), (0.3, 1.0, 0.0, math.inf),
    (0.3, 2.0, -math.inf, -1.0), (0.3, 1.0, 0.5, 0.5),
    (30.0, 0.1, -1.0, 1.0), (0.3, 0.0, -1.0, 1.0),
]


def test_constraints_match_jax():
    from lowlevelparticlefilters_jl_tpu_torch.ops import constraints as tcons

    for m, s, a, b in CONSTRAINT_CASES:
        got = tcons.truncated_scalar_moments(
            torch.tensor(m, dtype=torch.float64),
            torch.tensor(s, dtype=torch.float64), a, b)
        want = jcons.truncated_scalar_moments(jnp.asarray(m), jnp.asarray(s),
                                              a, b)
        for g, w in zip(got, want):
            np.testing.assert_allclose(np_of(g), np_of(w), rtol=1e-10,
                                       atol=1e-12)
    mu = np.array([0.8, -0.4, 1.5])
    L = np.array([[1.0, 0, 0], [0.4, 0.8, 0], [-0.3, 0.2, 0.5]])
    P = L @ L.T
    for idx, lo, hi in ((0, -0.5, 0.5), (2, 0.0, math.inf),
                        (1, -math.inf, -1.0), (0, -10.0, 10.0),
                        (1, 40.0, 41.0)):
        for tf, jf in ((tcons.project_bound, jcons.project_bound),
                       (tcons.truncated_moment_match,
                        jcons.truncated_moment_match)):
            xt, Pt = tf(torch.tensor(mu), torch.tensor(P), idx, lo, hi)
            xj, Pj = jf(jnp.asarray(mu), jnp.asarray(P), idx, lo, hi)
            np.testing.assert_allclose(np_of(xt), np_of(xj), rtol=1e-10,
                                       atol=1e-10)
            np.testing.assert_allclose(np_of(Pt), np_of(Pj), rtol=1e-9,
                                       atol=1e-10)


def test_discretize_matches_jax():
    for name in ("double_integrator_covariance",
                 "double_integrator_covariance_smooth"):
        np.testing.assert_allclose(np_of(getattr(llpt, name)(0.1, 2.0)),
                                   np_of(getattr(jdisc, name)(0.1, 2.0)),
                                   rtol=1e-14)
    for name in ("n_integrator_covariance", "n_integrator_covariance_smooth"):
        for n in (1, 3):
            np.testing.assert_allclose(
                np_of(getattr(llpt, name)(n, 0.2, 0.5)),
                np_of(getattr(jdisc, name)(n, 0.2, 0.5)), rtol=1e-14)

    def fj(x, u, p, t):
        return jnp.stack([x[1], -jnp.sin(x[0]) + u[0] * jnp.cos(t)])

    def ft(x, u, p, t):
        return torch.stack([x[1], -torch.sin(x[0])
                            + u[0] * math.cos(float(t))])

    x0, u0 = np.array([0.3, -0.2]), np.array([0.7])
    for ss in (1, 3):
        got = llpt.rk4(ft, 0.1, ss)(torch.tensor(x0), torch.tensor(u0),
                                    None, 0.5)
        want = jdisc.rk4(fj, 0.1, ss)(jnp.asarray(x0), jnp.asarray(u0),
                                      None, 0.5)
        np.testing.assert_allclose(np_of(got), np_of(want), rtol=1e-13)
    with pytest.raises(ValueError):
        llpt.rk4(ft, 0.1, 0)
