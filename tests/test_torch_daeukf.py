"""PyTorch port: the DAE unscented Kalman filter (filters/daeukf.py)
against the JAX package, in float64 on tests/test_daeukf.py's linear
scalar DAE (``ẋ = −x + z + w, 0 = x + z − c, y = z + v``).

- Deterministic, rtol 1e-9 (atol 1e-12): predict then correct over
  T = 30 steps (x, R, the descriptor xz and the residual norm of each
  correct), and ``forward_trajectory`` with a ``post_correct_cb`` that
  returns the residual norm as the step's extra (the monitoring the
  reference does with a warning).
- Against the analytic scalar KF of the reduced system, atol 1e-4, with
  the descriptor on the manifold, as the JAX test holds it.
- ``newton_constraint_solver``'s contract, and the two failure signals:
  a do-nothing solver shows in ``resnorm``, an indefinite R2 in
  ``sol.ok``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import (DAE_C1, DAE_DT, dae_callbacks, dae_filter,
                           dae_kf, np_of)

import lowlevelparticlefilters_jl_tpu as llpf
import lowlevelparticlefilters_jl_tpu_torch as llpt
from lowlevelparticlefilters_jl_tpu_torch import convert

Q, R, P0, X0 = 0.05, 0.02, 0.5, 0.3
T = 30
TOL = dict(rtol=1e-9, atol=1e-12)


def _jax_filter(**kw):
    x0 = jnp.array([X0])
    return llpf.DAEUnscentedKalmanFilter(
        *dae_callbacks(jnp), R1=jnp.array([[Q]]), R2=jnp.array([[R]]),
        d0=llpf.MvNormal(x0, jnp.array([[P0]])),
        xz0=jnp.concatenate([x0, DAE_C1 - x0]), nu=1, ny=1, Ts=DAE_DT, **kw)


def _ys(seed=0):
    rng = np.random.default_rng(seed)
    alpha, beta = 1 - 2 * DAE_DT, DAE_DT
    x, ys = X0 + 0.1, []
    for _ in range(T):
        x = alpha * x + beta * DAE_C1 + np.sqrt(Q) * rng.standard_normal()
        ys.append(DAE_C1 - x + np.sqrt(R) * rng.standard_normal())
    return np.array(ys)[:, None]


def test_daeukf_steps_match_jax_and_analytic_kf():
    ys = _ys()
    fj, ft = _jax_filter(), dae_filter(Q, R, P0, X0)
    uj, ut = jnp.array([0.0]), torch.zeros(1, dtype=torch.float64)

    @jax.jit
    def run(ys):
        def step(state, yk):
            state = fj.predict(state, uj)
            state, info = fj.correct(state, uj, yk)
            return state, (state.x, state.R, state.xz, info.resnorm)

        return jax.lax.scan(step, fj.init(), ys)[1]

    want = run(jnp.asarray(ys))
    st, got = ft.init(), []
    for k in range(T):
        st = ft.predict(st, ut)
        st, info = ft.correct(st, ut, torch.tensor(ys[k]))
        got.append((st.x, st.R, st.xz, info.resnorm))
    for i, name in enumerate(("x", "R", "xz")):
        np.testing.assert_allclose(np.stack([np_of(g[i]) for g in got]),
                                   np_of(want[i]), err_msg=name, **TOL)
    res = np.array([float(g[3]) for g in got])
    assert res.max() < 1e-12 and np.asarray(want[3]).max() < 1e-12
    xs_kf, Ps_kf = dae_kf(Q, R, P0, X0, ys[:, 0])
    np.testing.assert_allclose(np.array([float(g[0][0]) for g in got]),
                               xs_kf, atol=1e-4)
    np.testing.assert_allclose(np.array([float(g[1][0, 0]) for g in got]),
                               Ps_kf, atol=1e-4)
    cons = [abs(float(g[2].sum()) - DAE_C1) for g in got]
    assert max(cons) < 1e-12     # the descriptor stays on the manifold


def test_daeukf_forward_trajectory_with_callback_matches_jax():
    ys = _ys(1)
    us = np.zeros((T, 1))
    fj, ft = _jax_filter(), dae_filter(Q, R, P0, X0)

    def cb(f, state, info, u, y, p, t):
        return state, info.resnorm

    sj = llpf.forward_trajectory(fj, jnp.asarray(us), jnp.asarray(ys),
                                 post_correct_cb=cb)
    st = llpt.forward_trajectory(ft, torch.tensor(us), torch.tensor(ys),
                                 post_correct_cb=cb)
    for f in ("x", "xt", "R", "Rt", "ll", "e", "K"):
        np.testing.assert_allclose(np_of(getattr(st, f)),
                                   np_of(getattr(sj, f)), err_msg=f, **TOL)
    assert st.extra.shape == (T,) and float(st.extra.max()) < 1e-12
    # an indefinite R2 for every step: NaNs, every ok flag down
    bad = llpt.forward_trajectory(
        ft, torch.tensor(us[:5]), torch.tensor(ys[:5]),
        pre_correct_cb=lambda *a: -torch.ones(1, 1, dtype=torch.float64))
    assert not bool(bad.ok.any())


def test_newton_solver_and_failure_signals():
    """The built-in solver solves ``z³ = 8`` from 1; a do-nothing solver
    leaves the descriptor off the manifold, which ``resnorm`` shows, as
    in the JAX package; the constructor builds what the converter
    builds."""
    solve = llpt.newton_constraint_solver(iters=20)
    z = solve(lambda z: z ** 3 - 8.0, torch.tensor([1.0],
                                                   dtype=torch.float64))
    np.testing.assert_allclose(np_of(z), [2.0], atol=1e-6)
    zj = llpf.newton_constraint_solver(iters=20)(lambda z: z ** 3 - 8.0,
                                                 jnp.array([1.0]))
    np.testing.assert_allclose(np_of(z), np_of(zj), rtol=1e-12)
    bad = convert.daeukf_from_numpy(
        *dae_callbacks(torch), [[Q]], [[R]], [5.0], [[P0]],
        [5.0, DAE_C1 - X0], Ts=DAE_DT, nu=1, device="cpu",
        constraint_solver=lambda f, z0: z0)
    _, info = bad.correct(bad.init(), torch.zeros(1, dtype=torch.float64),
                          torch.zeros(1, dtype=torch.float64))
    assert float(info.resnorm) > 1.0
    good = dae_filter(Q, R, P0, X0)
    assert good.nx == 1 and good.ny == 1 and good.Ts == DAE_DT
    assert torch.equal(good.xz0, torch.tensor([X0, DAE_C1 - X0],
                                              dtype=torch.float64))
    assert good.init().xzs.shape == (3, 2)
