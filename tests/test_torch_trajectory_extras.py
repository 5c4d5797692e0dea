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
    pf = llpt.ParticleFilter(N=10, dynamics=lambda x, u, p, t: x,
                             measurement=lambda x, u, p, t: x,
                             dynamics_density=kt.R1,
                             measurement_density=kt.R2,
                             initial_density=kt.R1)
    with pytest.raises(TypeError):
        llpt.forward_trajectory(pf, torch.tensor(u), torch.tensor(y),
                                **_callbacks(torch))


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
