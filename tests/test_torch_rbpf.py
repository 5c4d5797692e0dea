"""PyTorch port: the Rao-Blackwellized particle filter (filters/rbpf.py)
against the JAX package, in float64 on the models of tests/test_rbpf.py.

- Draw for draw: the port draws only through ``filters/rbpf.py::_sample``
  (the initial cloud, each step's resampling offset r and process
  noise); the test replays there the JAX package's draws from the same
  keys, and ``forward_trajectory`` (the [xn, xl] cloud, w, we, ll) agrees
  within rtol 1e-9 (atol 1e-12) at N = 64, T = 20, on the coupled
  (``An``) model with one shared Riccati recursion and with one a
  particle, the all-nonlinear model (C = 0) and the augmented dynamics.
  The data are drawn so that no CDF of the resampled weights ties within
  an ulp (the systematic slots would then differ by rounding alone).
- Statistical, as the JAX tests make them: the all-linear, all-nonlinear
  and augmented-dynamics models within 1 % of the exact KF's ll; so is
  the coupled third-order integrator (``_torch_parity.rb_coupled``, the
  RBPF of ``chip_smoke.py`` phase 21 whose resampled rows vary in every
  column), with one Riccati recursion and with one a particle.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import RB_R2, np_of, rb_coupled, rb_linear_kf, rb_model

import lowlevelparticlefilters_jl_tpu as llpf
import lowlevelparticlefilters_jl_tpu_torch as llpt
from lowlevelparticlefilters_jl_tpu_torch import convert
from lowlevelparticlefilters_jl_tpu_torch.filters import rbpf as frb

N, T = 64, 20
TOL = dict(rtol=1e-9, atol=1e-12)
CASES = ("coupled", "coupled_per_particle", "nonlinear", "augmented")


def _jax_rbpf(case):
    if case.startswith("coupled"):
        kf = llpf.KalmanFilter(jnp.array([[0.95]]), jnp.zeros((1, 0)),
                               jnp.array([[1.0]]), 0, jnp.array([[0.01]]),
                               jnp.array([[0.1]]),
                               d0=llpf.MvNormal(jnp.array([1.0]),
                                                jnp.array([[1.0]])),
                               nu=0, ny=1)
        mm = llpf.RBMeasurementModel(
            measurement=lambda xn, u, p, t: 0.5 * jnp.sin(xn),
            R2=jnp.array([[0.1]]), ny=1)
        return llpf.RBPF(
            N=N, kf=kf,
            dynamics=lambda xn, u, p, t: 0.9 * xn + 0.1 * jnp.sin(xn),
            nl_measurement_model=mm, R1n=jnp.array([[0.01]]),
            d0n=llpf.MvNormal(jnp.array([1.0]), jnp.array([[0.01]])),
            An=jnp.array([[0.5]]), nu=0, resample_threshold=0.7,
            single_riccati=case == "coupled")
    A, B, C = (jnp.array([[1.0, 0.1], [0.0, 1.0]]), jnp.array([[0.0], [1.0]]),
               jnp.array([[1.0, 0.0]]))
    R1 = llpf.double_integrator_covariance(0.1) + 1e-6 * jnp.eye(2)
    kf2 = llpf.KalmanFilter(
        jnp.zeros((1, 1)), jnp.zeros((1, 1)), jnp.zeros((1, 1)), 0,
        jnp.eye(1), jnp.asarray(RB_R2),
        d0=llpf.MvNormal(jnp.zeros(1), jnp.array([[0.0]])), nu=1, ny=1)
    mm = llpf.RBMeasurementModel(measurement=lambda xn, u, p, t: C @ xn,
                                 R2=jnp.asarray(RB_R2), ny=1)
    dyn = ((lambda xn, u, p, t: A @ xn + B @ u) if case == "nonlinear" else
           (lambda xn, u, p, t, w: A @ xn + B @ u + w))
    return llpf.RBPF(N=N, kf=kf2, dynamics=dyn, nl_measurement_model=mm,
                     R1n=R1, d0n=llpf.MvNormal(jnp.zeros(2), 2 * jnp.eye(2)),
                     An=None, nu=1, augmented_dynamics=case == "augmented",
                     resample_threshold=1.0)


def _port_rbpf(case):
    if case.startswith("coupled"):
        kf = convert.kalman_filter_from_numpy(
            [[0.95]], np.zeros((1, 0)), [[1.0]], 0, [[0.01]], [[0.1]],
            [1.0], [[1.0]], device="cpu")
        return convert.rbpf_from_numpy(
            N, kf, lambda xn, u, p, t: 0.9 * xn + 0.1 * torch.sin(xn),
            lambda xn, u, p, t: 0.5 * torch.sin(xn), [[0.1]], [[0.01]],
            [[0.01]], d0n_mean=[1.0], An=[[0.5]], nu=0,
            resample_threshold=0.7, single_riccati=case == "coupled",
            dtype=torch.float64, device="cpu")
    return rb_model(case, N, 1.0)


def _jax_draws(fj, key, steps):
    """The JAX RBPF's draws in the port's order: the initial cloud, then
    each step's resampling offset r (drawn whether or not the trigger
    fires, as JAX splits its key every step) and process noise."""
    key, kn = jax.random.split(key)
    out = [fj.d0n.sample(kn, (fj.N,))]
    for _ in range(steps):
        key, kr = jax.random.split(key)
        out.append(jax.random.uniform(kr, (), jnp.float64))
        key, kw = jax.random.split(key)
        if fj.augmented_dynamics:
            out.append(jnp.stack([fj.R1n.sample(k)
                                  for k in jax.random.split(kw, fj.N)]))
        else:
            out.append(fj.R1n.sample(kw, (fj.N,)))
    return [torch.tensor(np.asarray(d)) for d in out]


def _data(case, seed=4):
    rng = np.random.default_rng(seed)
    if case.startswith("coupled"):
        return np.zeros((T, 0)), 1.0 + 0.3 * rng.normal(size=(T, 1))
    kf = rb_linear_kf()
    u = torch.tensor(rng.normal(size=(T, 1)))
    _, _, y = llpt.simulate(kf, u, torch.Generator().manual_seed(seed))
    return u.numpy(), y.numpy()


@pytest.mark.parametrize("case", CASES)
def test_rbpf_draw_for_draw_matches_jax(monkeypatch, case):
    fj, ft = _jax_rbpf(case), _port_rbpf(case)
    assert (ft.single_riccati, ft.zero_C) == (fj.single_riccati, fj.zero_C)
    u, y = _data(case)
    key = jax.random.PRNGKey(3)
    draws = _jax_draws(fj, key, T)
    monkeypatch.setattr(frb, "_sample", lambda *a, **k: draws.pop(0))
    sj = llpf.forward_trajectory(fj, jnp.asarray(u), jnp.asarray(y), key=key)
    st = llpt.forward_trajectory(ft, torch.tensor(u), torch.tensor(y),
                                 generator=torch.Generator().manual_seed(0))
    assert not draws and st.route == "sequential"
    for f in ("x", "w", "we", "ll"):
        np.testing.assert_allclose(np_of(getattr(st, f)),
                                   np_of(getattr(sj, f)), err_msg=f, **TOL)


@pytest.mark.parametrize("which,Np,threshold", [
    ("linear", 500, 0.1), ("nonlinear", 2000, 1.0), ("augmented", 2000, 1.0)])
def test_rbpf_ll_near_kf(which, Np, threshold):
    """tests/test_rbpf.py's degenerate models within 1 % of the exact
    KF's ll (T = 50); ``loglik`` through the verb equals
    ``forward_trajectory``'s ll on the same generator seed."""
    kf = rb_linear_kf()
    rng = np.random.default_rng(42)
    u = torch.tensor(rng.normal(size=(50, 1)))
    _, _, y = llpt.simulate(kf, u, torch.Generator().manual_seed(43))
    ll_kf = float(llpt.loglik(kf, u, y))
    pf = rb_model(which, Np, threshold)
    assert pf.single_riccati and pf.zero_C == (which != "linear")
    sol = llpt.forward_trajectory(pf, u, y,
                                  generator=torch.Generator().manual_seed(1))
    assert abs(float(sol.ll) - ll_kf) < 0.01 * abs(ll_kf), (sol.ll, ll_kf)
    ll = llpt.loglik(pf, u, y, generator=torch.Generator().manual_seed(1))
    assert llpt.last_route("loglik") == "sequential"
    np.testing.assert_allclose(float(ll), float(sol.ll), rtol=1e-12)


@pytest.mark.parametrize("single_riccati", [True, False])
def test_rbpf_coupled_ll_near_kf(single_riccati):
    """The coupled RBPF (``An``, C != 0, a resample every step) of the
    third-order integrator within 1 % of its exact KF's ll (N = 2000,
    T = 50); with one Riccati recursion a particle the rows carry vec(R)
    and the ll is the shared recursion's on the same draws."""
    rng = np.random.default_rng(214)
    u = torch.tensor(rng.normal(size=(50, 1)))
    pf, kf = rb_coupled(2000, 1.0, single_riccati)
    _, _, y = llpt.simulate(kf, u, torch.Generator().manual_seed(215))
    ll_kf = float(llpt.loglik(kf, u, y))
    assert pf.single_riccati == single_riccati and not pf.zero_C
    sol = llpt.forward_trajectory(pf, u, y,
                                  generator=torch.Generator().manual_seed(1))
    assert sol.x.shape == (50, 2000, 3)
    assert abs(float(sol.ll) - ll_kf) < 0.01 * abs(ll_kf), (sol.ll, ll_kf)
    shared = llpt.forward_trajectory(
        rb_coupled(2000, 1.0)[0], u, y,
        generator=torch.Generator().manual_seed(1))
    np.testing.assert_allclose(float(sol.ll), float(shared.ll), rtol=1e-10)


def test_rbpf_convert_and_alias():
    """``convert.rbpf_from_numpy`` builds the filter the direct
    constructors build; ``RBParticle`` is ``RBState``; the per-step
    callbacks are accepted and ignored."""
    ft = _port_rbpf("coupled")
    kf = ft.kf
    direct = llpt.RBPF(
        N=N, kf=kf, dynamics=ft.dynamics,
        nl_measurement_model=llpt.RBMeasurementModel(
            measurement=ft.nl_measurement_model.measurement,
            R2=torch.tensor([[0.1]], dtype=torch.float64), ny=1),
        R1n=torch.tensor([[0.01]], dtype=torch.float64),
        d0n=llpt.MvNormal(torch.tensor([1.0], dtype=torch.float64),
                          torch.tensor([[0.01]], dtype=torch.float64)),
        An=torch.tensor([[0.5]], dtype=torch.float64), nu=0)
    assert direct.single_riccati and ft.single_riccati
    for name in ("R1n", "d0n", "nl_measurement_model"):
        a, b = getattr(ft, name), getattr(direct, name)
        a, b = (getattr(a, "R2", a), getattr(b, "R2", b))
        assert torch.equal(a.cov, b.cov) and torch.equal(a.mean, b.mean)
    assert torch.equal(ft.An, direct.An)
    assert (ft.nxn, ft.nxl, ft.nx, ft.ny) == (1, 1, 2, 1)
    assert llpt.RBParticle is llpt.RBState
    u, y = _data("coupled")
    calls = []
    sol = llpt.forward_trajectory(ft, torch.tensor(u), torch.tensor(y),
                                  generator=torch.Generator().manual_seed(0),
                                  post_correct_cb=lambda *a: calls.append(1))
    assert not calls and sol.x.shape == (T, N, 2)
