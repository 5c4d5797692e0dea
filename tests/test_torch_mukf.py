"""PyTorch port: the marginalized UKF (filters/mukf.py) against the JAX
package, in float64 on the models of tests/test_mukf.py.

Deterministic, rtol 1e-9 and atol 1e-9: ``forward_trajectory`` (x, xt, R,
Rt, ll, e, K) on the linear oracle with an artificial nonlinear/linear
split (also with the substates' order swapped through ``n_inds`` /
``l_inds``, and against the exact KF, rtol 1e-6 as the JAX test holds
it) and on the tutorial system (atan dynamics, a quadratic measurement
of xn, three linear states).  The absolute tolerance is that of the
default van der Merwe weights (alpha = 1e-3): the centre weight is about
-1e6, so each UT sum cancels six digits and rounding alone leaves
differences near 1e-10 on values near zero.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import np_of

import lowlevelparticlefilters_jl_tpu as llpf
import lowlevelparticlefilters_jl_tpu_torch as llpt
from lowlevelparticlefilters_jl_tpu_torch import convert

TOL = dict(rtol=1e-9, atol=1e-9)
R1_LIN = np.diag([0.01, 0.01])


def _linear(order, xp):
    """The linear oracle's MUKF pieces in ``xp``; ``order`` "nl" puts the
    nonlinear state first, "ln" last."""
    arr = lambda a: xp.asarray(a, dtype=xp.float64)  # noqa: E731
    if order == "nl":
        fn = lambda xn, u, p, t: xp.stack([0.9 * xn[0], 0.0 * xn[0]])  # noqa
        A, m0, inds = [[0.2], [0.95]], [0.5, 0.3], {}
    else:
        fn = lambda xn, u, p, t: xp.stack([0.0 * xn[0], 0.9 * xn[0]])  # noqa
        A, m0, inds = [[0.95], [0.2]], [0.3, 0.5], dict(n_inds=(1,),
                                                         l_inds=(0,))
    g = lambda xn, u, p, t: xp.stack([xn[0], 0.0 * xn[0]])  # noqa: E731
    return fn, g, arr(A), arr([[0.0], [0.5]]), m0, inds


def _tutorial(xp):
    arr = lambda a: xp.asarray(a, dtype=xp.float64)  # noqa: E731
    fn = lambda xn, u, p, t: xp.concatenate(  # noqa: E731
        [xp.arctan(xn), 0.0 * xp.concatenate([xn, xn, xn])])
    g = lambda xn, u, p, t: xp.stack(  # noqa: E731
        [0.1 * xn[0] ** 2 * xp.sign(xn[0]), 0.0 * xn[0]])
    A = arr([[1.0, 0.0, 0.0], [1.0, 0.3, 0.0], [0.0, 0.92, -0.3],
             [0.0, 0.3, 0.92]])
    Cl = arr([[0.0, 0.0, 0.0], [1.0, -1.0, 1.0]])
    return fn, g, A, Cl


def _pair(fn_j, g_j, fn_t, g_t, A, Cl, R1, R2, m0, P0, nxn, **kw):
    mm = llpf.RBMeasurementModel(measurement=g_j, R2=jnp.asarray(R2),
                                 ny=R2.shape[0])
    fj = llpf.MUKF(dynamics=fn_j, nl_measurement_model=mm,
                   A=jnp.asarray(A), Cl=jnp.asarray(Cl), R1=jnp.asarray(R1),
                   d0=llpf.MvNormal(jnp.asarray(m0), jnp.asarray(P0)),
                   nxn=nxn, nu=0, ny=R2.shape[0], **kw)
    ft = convert.mukf_from_numpy(fn_t, g_t, np.asarray(A), np.asarray(Cl),
                                 R1, R2, m0, P0, nxn, nu=0, device="cpu",
                                 **kw)
    return fj, ft


def _run(fj, ft, y):
    u = np.zeros((y.shape[0], 0))
    sj = llpf.forward_trajectory(fj, jnp.asarray(u), jnp.asarray(y))
    st = llpt.forward_trajectory(ft, torch.tensor(u), torch.tensor(y))
    for f in ("x", "xt", "R", "Rt", "ll", "e", "K"):
        np.testing.assert_allclose(np_of(getattr(st, f)),
                                   np_of(getattr(sj, f)), err_msg=f, **TOL)
    assert st.route == "sequential"
    return st


@pytest.mark.parametrize("order", ["nl", "ln"])
def test_mukf_linear_oracle_matches_jax_and_kf(order):
    y = np.random.default_rng(0).normal(size=(60, 2)) * 0.5
    fj_, gj, Aj, Clj, m0, inds = _linear(order, jnp)
    ft_, gt, *_ = _linear(order, torch)
    fj, ft = _pair(fj_, gj, ft_, gt, Aj, Clj, R1_LIN, 0.1 * np.eye(2), m0,
                   np.diag([0.1, 0.1]), 1, **inds)
    st = _run(fj, ft, y)
    if order == "ln":
        assert ft.n_inds == (1,) and ft.l_inds == (0,)
        return
    kf = convert.kalman_filter_from_numpy(
        [[0.9, 0.2], [0.0, 0.95]], np.zeros((2, 0)), [[1.0, 0.0],
                                                      [0.0, 0.5]], 0,
        R1_LIN, 0.1 * np.eye(2), m0, np.diag([0.1, 0.1]), device="cpu")
    sk = llpt.forward_trajectory(kf, torch.zeros(60, 0, dtype=torch.float64),
                                 torch.tensor(y))
    np.testing.assert_allclose(float(st.ll), float(sk.ll), rtol=1e-6)
    np.testing.assert_allclose(np_of(st.xt), np_of(sk.xt), atol=1e-6)


def test_mukf_tutorial_system_matches_jax():
    rng = np.random.default_rng(2)
    y = np.stack([0.3 * rng.normal(size=50), rng.normal(size=50)], 1)
    fj_, gj, Aj, Clj = _tutorial(jnp)
    ft_, gt, *_ = _tutorial(torch)
    fj, ft = _pair(fj_, gj, ft_, gt, Aj, Clj, np.diag([0.01] * 4),
                   0.1 * np.eye(2), np.zeros(4), np.diag([1.0, .01, .01, .01]),
                   1)
    st = _run(fj, ft, y)
    assert np.linalg.eigvalsh(np_of(st.Rt)).min() > -1e-8


def test_mukf_helpers_and_convert():
    """``partition_cov``/``cond_linear_params`` against the JAX package;
    ``convert.mukf_from_numpy`` builds what the direct constructor
    builds."""
    M = np.random.default_rng(1).normal(size=(4, 4))
    P = M @ M.T + np.eye(4)
    bj = llpf.partition_cov(jnp.asarray(P), (1, 3), (0, 2))
    bt = llpt.partition_cov(torch.tensor(P), (1, 3), (0, 2))
    for a, b in zip(bt, bj):
        np.testing.assert_array_equal(np_of(a), np_of(b))
    for a, b in zip(llpt.cond_linear_params(*bt),
                    llpf.cond_linear_params(*bj)):
        np.testing.assert_allclose(np_of(a), np_of(b), **TOL)
    ft_, gt, A, Cl = _tutorial(torch)
    ft = convert.mukf_from_numpy(ft_, gt, A.numpy(), Cl.numpy(),
                                 np.diag([0.01] * 4), 0.1 * np.eye(2),
                                 np.zeros(4), np.eye(4), 1, device="cpu")
    direct = llpt.MUKF(
        dynamics=ft_, nl_measurement_model=llpt.RBMeasurementModel(
            measurement=gt, R2=0.1 * torch.eye(2, dtype=torch.float64),
            ny=2),
        A=A, Cl=Cl, R1=torch.diag(torch.full((4,), 0.01,
                                             dtype=torch.float64)),
        d0=llpt.MvNormal(torch.zeros(4, dtype=torch.float64),
                         torch.eye(4, dtype=torch.float64)), nxn=1)
    for name in ("A", "Cl", "R1"):
        assert torch.equal(getattr(ft, name), getattr(direct, name)), name
    assert (ft.nx, ft.nxl, ft.ny, ft.l_inds) == (4, 3, 2, (1, 2, 3))
    assert ft.weight_params == direct.weight_params


@pytest.mark.parametrize("dtype,alpha,warns", [
    (torch.float32, 1e-3, True), (torch.float64, 1e-3, False),
    (torch.float32, 1.0, False)])
def test_mukf_warns_where_ut_sums_cancel(dtype, alpha, warns):
    """The default weights (alpha = 1e-3) in float32 lose about 0.1 of
    each UT sum to rounding: the filter warns when it is built; float64,
    or alpha = 1 in float32, builds silently."""
    import warnings

    from lowlevelparticlefilters_jl_tpu_torch.models.sigmapoints import (
        MerweParams)

    ft_, gt, A, Cl = _tutorial(torch)
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        convert.mukf_from_numpy(ft_, gt, A.numpy(), Cl.numpy(),
                                np.diag([0.01] * 4), 0.1 * np.eye(2),
                                np.zeros(4), np.eye(4), 1,
                                weight_params=MerweParams(alpha=alpha),
                                dtype=dtype, device="cpu")
    said = [w for w in got if "unscented sums lose" in str(w.message)]
    assert bool(said) == warns, [str(w.message) for w in got]
