"""PyTorch port: ``sse``, ``loglik_x``, ``rollout``, ``simulate`` (its
integer-T form with an input density), ``simulate_ensemble``, the four
per-step callbacks of ``forward_trajectory`` and the flat accessor verbs
(``compat.py``), against the JAX package on the same numpy inputs in
float64, rtol 1e-10 (the same recursions; only rounding differs).

Random draws cannot match JAX's keys, so the stochastic forms are held
to their shapes and their input rule, and the noise-free forms to the
JAX package's values."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import A, B, C, R1, R2, np_of

import lowlevelparticlefilters_jl_tpu as llpf
import lowlevelparticlefilters_jl_tpu_torch as llpt
from lowlevelparticlefilters_jl_tpu_torch import convert

T = 50
RTOL = dict(rtol=1e-10, atol=1e-12)
D0M, D0C = np.array([0.5, -0.2]), 2.0 * np.eye(2)


def _kf_pair():
    kj = llpf.KalmanFilter(jnp.asarray(A), jnp.asarray(B), jnp.asarray(C), 0,
                           jnp.asarray(R1), jnp.asarray(R2),
                           d0=llpf.MvNormal(jnp.asarray(D0M),
                                            jnp.asarray(D0C)))
    kt = convert.kalman_filter_from_numpy(A, B, C, 0, R1, R2, D0M, D0C,
                                          device="cpu")
    return kj, kt


def _data(seed=0):
    rng = np.random.default_rng(seed)
    return (0.3 + 0.1 * rng.normal(size=(T, 1)), rng.normal(size=(T, 2)),
            rng.normal(size=(T, 2)))


@pytest.mark.parametrize("lam", ["scalar", "vector", "matrix"])
def test_sse_matches_jax(lam):
    kj, kt = _kf_pair()
    u, y, _ = _data(1)
    lv = {"scalar": 2.0, "vector": np.array([1.0, 3.0]),
          "matrix": np.array([[2.0, 0.5], [0.5, 1.0]])}[lam]
    got = llpt.sse(kt, torch.tensor(u), torch.tensor(y), lam=lv)
    want = llpf.sse(kj, jnp.asarray(u), jnp.asarray(y), lam=jnp.asarray(lv))
    np.testing.assert_allclose(float(got), float(want), **RTOL)


def test_loglik_x_and_rollout_match_jax():
    kj, kt = _kf_pair()
    u, y, x = _data(2)
    np.testing.assert_allclose(
        float(llpt.loglik_x(kt, torch.tensor(u), torch.tensor(y),
                            torch.tensor(x))),
        float(llpf.loglik_x(kj, jnp.asarray(u), jnp.asarray(y),
                            jnp.asarray(x))), **RTOL)
    got = llpt.rollout(kt.dynamics_fn(), torch.tensor(D0M), torch.tensor(u),
                       Ts=0.5)
    want = llpf.rollout(kj.dynamics_fn(), jnp.asarray(D0M), jnp.asarray(u),
                        Ts=0.5)
    assert got.shape == (T + 1, 2)
    np.testing.assert_allclose(np_of(got), np_of(want), **RTOL)


def _callbacks(xp):
    """The four per-step callbacks in ``xp`` (jnp or torch): R2 scaled by
    the step's input, the filtered state pulled toward zero with ll as the
    extra, R1 scaled by the step's |e|, and a predicted state nudged."""
    def pre_correct(f, s, u, y, p, t):
        return f.R2 * (1.0 + u[0] ** 2)

    def post_correct(f, s, info, u, y, p, t):
        return s.replace(x=0.99 * s.x), (info.ll, 2.0 * info.e)

    def pre_predict(f, s, u, y, p, t, info):
        return f.R1 * (1.0 + 0.1 * xp.abs(info.e[0]))

    def post_predict(f, s, u, y, p, t):
        return s.replace(x=s.x + 0.01)

    return dict(pre_correct_cb=pre_correct, post_correct_cb=post_correct,
                pre_predict_cb=pre_predict, post_predict_cb=post_predict)


def test_forward_trajectory_callbacks_match_jax():
    kj, kt = _kf_pair()
    u, y, _ = _data(3)
    sj = llpf.forward_trajectory(kj, jnp.asarray(u), jnp.asarray(y),
                                 **_callbacks(jnp))
    st = llpt.forward_trajectory(kt, torch.tensor(u), torch.tensor(y),
                                 method="parallel", **_callbacks(torch))
    assert st.route == "sequential"
    for f in ("x", "xt", "R", "Rt", "e", "K", "ll"):
        np.testing.assert_allclose(np_of(getattr(st, f)),
                                   np_of(getattr(sj, f)), err_msg=f, **RTOL)
    for a, b in zip(st.extra, sj.extra):
        np.testing.assert_allclose(np_of(a), np_of(b), **RTOL)
    assert bool(st.ok.all())
    # a filter with a forward_trajectory of its own is handed the
    # callbacks (the PF runs them, in the JAX package's order)
    pf = llpt.ParticleFilter(N=10, dynamics=lambda x, u, p, t: x,
                             measurement=lambda x, u, p, t: x,
                             dynamics_density=kt.R1,
                             measurement_density=kt.R2,
                             initial_density=kt.R1)
    calls = []
    cbs = {name: (lambda name: lambda *a: calls.append(name))(name)
           for name in _callbacks(torch)}
    llpt.forward_trajectory(pf, torch.tensor(u), torch.tensor(y),
                            generator=torch.Generator().manual_seed(0), **cbs)
    assert calls == ["pre_correct_cb", "post_correct_cb", "pre_predict_cb",
                     "post_predict_cb"] * T


def test_simulate_forms():
    """Noise-free ``simulate`` equals the JAX package's; the integer-T form
    draws its inputs from ``du``; ``simulate_ensemble`` stacks runs and
    returns the shared ``u`` as it is, or every run's own draws."""
    kj, kt = _kf_pair()
    u, _, _ = _data(4)
    xt, ut, yt = llpt.simulate(kt, torch.tensor(u), None,
                               dynamics_noise=False, measurement_noise=False)
    xj, uj, yj = llpf.simulate(kj, jnp.asarray(u), jax.random.PRNGKey(0),
                               dynamics_noise=False, measurement_noise=False)
    np.testing.assert_allclose(np_of(xt), np_of(xj), **RTOL)
    np.testing.assert_allclose(np_of(yt), np_of(yj), **RTOL)
    g = torch.Generator().manual_seed(5)
    du = llpt.MvNormal(torch.tensor([0.3], dtype=torch.float64),
                       torch.tensor([[0.01]], dtype=torch.float64))
    x1, u1, y1 = llpt.simulate(kt, 25, g, du=du)
    assert x1.shape == (25, 2) and u1.shape == (25, 1) and y1.shape == (25, 2)
    with pytest.raises(ValueError):
        llpt.simulate(kt, 25, g)
    xs, us, ys = llpt.simulate_ensemble(kt, torch.tensor(u), g, 4)
    assert xs.shape == (4, T, 2) and ys.shape == (4, T, 2)
    assert torch.equal(us, torch.tensor(u))
    assert not torch.equal(ys[0], ys[1])
    xs, us, ys = llpt.simulate_ensemble(kt, 25, g, 3, du=du)
    assert us.shape == (3, 25, 1) and not torch.equal(us[0], us[1])
    xe, ue, ye = llpt.simulate_ensemble(kt, torch.tensor(u), g, 2,
                                        dynamics_noise=False,
                                        measurement_noise=False)
    assert torch.equal(ye[0], ye[1]) and torch.equal(ye[0], yt)


def test_compat_verbs_match_jax():
    kj, kt = _kf_pair()
    u, y, _ = _data(5)
    sj, st = kj.init(), llpt.reset(kt)
    for _ in range(3):
        sj, ij = llpf.update(kj, sj, jnp.asarray(u[0]), jnp.asarray(y[0]))
        st, it = llpt.update(kt, st, torch.tensor(u[0]), torch.tensor(y[0]))
    sj2 = llpf.predict(kj, sj, jnp.asarray(u[1]))
    st2 = llpt.predict(kt, st, torch.tensor(u[1]))
    sj3, _ = llpf.correct(kj, sj2, jnp.asarray(u[1]), jnp.asarray(y[1]))
    st3, _ = llpt.correct(kt, st2, torch.tensor(u[1]), torch.tensor(y[1]))
    for a, b in ((llpt.state(st3), llpf.state(sj3)),
                 (llpt.covariance(st3), llpf.covariance(sj3)),
                 (it.ll, ij.ll)):
        np.testing.assert_allclose(np_of(a), np_of(b), **RTOL)
    assert int(llpt.index(st2)) == int(llpf.index(sj2)) == 4
    rng = np.random.default_rng(6)
    x, w = rng.normal(size=(50, 2)), rng.normal(size=50)
    w = w - np.log(np.exp(w).sum())
    pj = llpf.PFState(x=jnp.asarray(x), w=jnp.asarray(w),
                      we=jnp.asarray(np.exp(w)), t=0,
                      key=jax.random.PRNGKey(0))
    pt = llpt.PFState(x=torch.tensor(x), w=torch.tensor(w),
                      we=torch.tensor(np.exp(w)), t=0)
    for a, b in ((llpt.state(pt), llpf.state(pj)),
                 (llpt.covariance(pt), llpf.covariance(pj)),
                 (llpt.particles(pt), llpf.particles(pj)),
                 (llpt.weights(pt), llpf.weights(pj)),
                 (llpt.expweights(pt), llpf.expweights(pj))):
        np.testing.assert_allclose(np_of(a), np_of(b), **RTOL)
    assert llpt.num_particles(pt) == 50 and llpt.particletype(pt) == \
        torch.float64
    for th in (0.1, 0.9):
        assert bool(llpt.shouldresample(pt.we, th)) == bool(
            llpf.shouldresample(pj.we, th))
    with pytest.warns(DeprecationWarning):
        np.testing.assert_allclose(
            np_of(llpt.weigthed_mean(pt.x, pt.we)),
            np_of(llpt.weighted_mean(pt.x, pt.we)))
    yt = llpt.sample_measurement(kt, None, torch.tensor(D0M), noise=False)
    np.testing.assert_allclose(np_of(yt), C @ D0M, **RTOL)


# ---- the verbs hand callbacks and method= as the JAX package does ---------


NPF, TPF = 64, 20


def _pf_pair():
    """The linear model's bootstrap PF in both packages, without process
    noise (so the only draw of a step is the resampling offset r; every
    step resamples, as the JAX package splits its key every step), and a
    shared initial state: ``(pj, pt, sj, st)``."""
    Aj, Bj, Cj = (jnp.asarray(M) for M in (A, B, C))
    pj = llpf.ParticleFilter(
        N=NPF, dynamics=lambda x, u, p, t: Aj @ x + Bj @ u,
        measurement=lambda x, u, p, t: Cj @ x, dynamics_density=None,
        measurement_density=jnp.asarray(R2),
        initial_density=jnp.asarray(D0C), resample_threshold=1.0)
    fs, gs = convert.linear_callbacks(A, B, C, dtype=torch.float64,
                                      device="cpu")
    pt = convert.particle_filter_from_numpy(
        NPF, fs, gs, R1, R2, D0C, resample_threshold=1.0,
        dtype=torch.float64, device="cpu").replace(dynamics_density=None)
    from lowlevelparticlefilters_jl_tpu.filters.particle import (
        PFState as JState)

    x0 = np.random.default_rng(7).normal(size=(NPF, 2))
    w0 = np.full(NPF, -np.log(NPF))
    sj = JState(x=jnp.asarray(x0), w=jnp.asarray(w0),
                we=jnp.asarray(np.exp(w0)), t=jnp.asarray(0, jnp.int32),
                key=jax.random.PRNGKey(5))
    st = llpt.PFState(x=torch.tensor(x0), w=torch.tensor(w0),
                      we=torch.tensor(np.exp(w0)), t=0,
                      generator=torch.Generator().manual_seed(0))
    return pj, pt, sj, st


def _jax_offsets(key, n):
    """The resampling offsets r the JAX PF draws over n steps without
    process noise: each step splits its key and draws r from the split."""
    rs = []
    for _ in range(n):
        key, kr = jax.random.split(key)
        rs.append(float(jax.random.uniform(kr, (), jnp.float64)))
    return rs


def test_pf_forward_trajectory_runs_callbacks_as_jax(monkeypatch):
    """``forward_trajectory(pf, ..., post_correct_cb=...)`` hands the
    callbacks to the PF's own ``forward_trajectory``: a post-correct
    callback that records ``state.we`` and tempers the weights, a
    post-predict one that nudges the particles, and the two pre-callbacks
    (results ignored), against the JAX package at N = 64, T = 20 in
    float64 with the JAX draws of r fed to the port; rtol 1e-10."""
    from lowlevelparticlefilters_jl_tpu_torch.kernels import resample_v2
    from lowlevelparticlefilters_jl_tpu_torch.ops import resample as trs

    pj, pt, sj, st = _pf_pair()
    rs = iter(_jax_offsets(sj.key, TPF))
    for mod in (trs, resample_v2):
        monkeypatch.setattr(mod, "_uniform", lambda *a: torch.tensor(
            next(rs), dtype=torch.float64))
    u, y, _ = _data(8)
    u, y = u[:TPF], y[:TPF]

    def cbs(xp, rec):
        def post_correct(f, s, info, u, y, p, t):
            rec(s.we)
            w = 0.5 * s.w
            w = w - xp.log(xp.exp(w).sum())
            return s.replace(w=w, we=xp.exp(w))

        def post_predict(f, s, u, y, p, t):
            return s.replace(x=s.x + 0.01)

        return dict(pre_correct_cb=lambda *a: None,
                    post_correct_cb=post_correct,
                    pre_predict_cb=lambda *a: None,
                    post_predict_cb=post_predict)

    got_we, want_we = [], []
    st_sol = llpt.forward_trajectory(pt, torch.tensor(u), torch.tensor(y),
                                     state0=st,
                                     **cbs(torch, got_we.append))
    sj_sol = llpf.forward_trajectory(
        pj, jnp.asarray(u), jnp.asarray(y), state0=sj,
        **cbs(jnp, lambda we: jax.debug.callback(
            lambda v: want_we.append(np.asarray(v)), we, ordered=True)))
    assert len(got_we) == len(want_we) == TPF
    np.testing.assert_allclose(np.stack([np_of(w) for w in got_we]),
                               np.stack(want_we), **RTOL)
    for f in ("x", "w", "we", "ll"):
        np.testing.assert_allclose(np_of(getattr(st_sol, f)),
                                   np_of(getattr(sj_sol, f)), err_msg=f,
                                   **RTOL)
    assert llpt.last_route("forward_trajectory") == "sequential"


class _OwnLoglik:
    """A filter whose own ``loglik(u, y, p)`` takes no ``method``, as the
    JAX package's EnKF, IMM and RBPF: the KF's sequential recursion."""

    def __init__(self, kf):
        self.kf = kf

    def loglik(self, u, y, p=None):
        return llpt.loglik(self.kf, u, y, p, method="sequential")


def test_loglik_calls_own_loglik_without_method():
    """``loglik(f, u, y)`` passes ``method`` only to the particle filters:
    another filter's own ``loglik`` is called without it and the verb
    records the sequential route, as the JAX package does."""
    kj, kt = _kf_pair()
    u, y, _ = _data(9)
    got = llpt.loglik(_OwnLoglik(kt), torch.tensor(u), torch.tensor(y))
    assert llpt.last_route("loglik") == "sequential"
    want = llpf.loglik(kj, jnp.asarray(u), jnp.asarray(y),
                       method="sequential")
    np.testing.assert_allclose(float(got), float(want), **RTOL)
    with pytest.raises(ValueError):
        llpt.loglik(_OwnLoglik(kt), torch.tensor(u), torch.tensor(y),
                    method="bogus")
