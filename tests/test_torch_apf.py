"""PyTorch port: the auxiliary and advanced particle filters
(filters/particle.py) against the JAX package.

One predict step of each, from a shared state, with no process noise and
the JAX draw of the resampling offset r handed to the port, must give the
same cloud and weights; then each filter's ll on the linear model within
2 % of the Kalman filter's at N = 2000.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lowlevelparticlefilters_jl_tpu as llpf
from lowlevelparticlefilters_jl_tpu.filters.particle import (
    PFState as JState)
import lowlevelparticlefilters_jl_tpu_torch as llpt
from lowlevelparticlefilters_jl_tpu_torch import convert
from lowlevelparticlefilters_jl_tpu_torch.kernels import resample_v2
from lowlevelparticlefilters_jl_tpu_torch.ops import resample as trs
from _torch_parity import A, B, C, R1, R2

N = 256
L1 = np.linalg.cholesky(R1)


def _jax_filters(th=1.0):
    Aj, Bj, Cj, R2j = (jnp.asarray(M) for M in (A, B, C, R2))
    f = lambda x, u, p, t: Aj @ x + Bj @ u  # noqa: E731
    g = lambda x, u, p, t: Cj @ x  # noqa: E731
    d0 = llpf.MvNormal(jnp.zeros(2), jnp.eye(2))
    pf = llpf.ParticleFilter(N=N, dynamics=f, measurement=g,
                             dynamics_density=None, measurement_density=R2j,
                             initial_density=d0, resample_threshold=th)

    def adyn(x, u, p, t, key):  # noise off in the parity step
        return f(x, u, p, t)

    adv = llpf.AdvancedParticleFilter(
        N=N, dynamics=adyn, measurement=lambda x, u, p, t, key: g(x, u, p, t),
        measurement_likelihood=lambda x, u, y, p, t: llpf.mvnormal_logpdf_cov(
            y - g(x, u, p, t), jnp.zeros(2), R2j),
        initial_density=d0, resample_threshold=th)
    return pf, adv


def _port_filters(th=1.0, N=N, noise=False, **kw):
    f, g = convert.linear_callbacks(A, B, C, dtype=torch.float64,
                                    device="cpu")
    L = torch.tensor(L1)
    dm = llpt.MvNormal(torch.zeros(2, dtype=torch.float64),
                       torch.tensor(R2))
    pf = convert.particle_filter_from_numpy(
        N, f, g, R1, R2, R1 if noise else np.eye(2), resample_threshold=th,
        dtype=torch.float64, device="cpu", **kw)
    if not noise:
        pf = pf.replace(dynamics_density=None)
    adv = convert.advanced_particle_filter_from_numpy(
        N, lambda x, u, p, t, z: f(x, u, p, t) + (
            0 if z is None or not noise else L @ z),
        lambda x, u, p, t, z: g(x, u, p, t),
        lambda x, u, y, p, t: dm.logpdf(y - g(x, u, p, t)),
        R1 if noise else np.eye(2), resample_threshold=th,
        dtype=torch.float64, device="cpu", **kw)
    return pf, adv


def _shared_state(seed=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, 2))
    w = rng.normal(size=N)
    w = w - np.log(np.exp(w).sum())
    key = jax.random.PRNGKey(seed)
    js = JState(x=jnp.asarray(x), w=jnp.asarray(w),
                we=jnp.asarray(np.exp(w)), t=jnp.asarray(0, jnp.int32),
                key=key)
    ts = llpt.PFState(x=torch.tensor(x), w=torch.tensor(w),
                      we=torch.tensor(np.exp(w)), t=0,
                      generator=torch.Generator().manual_seed(0))
    _, kr = jax.random.split(key)
    r = torch.tensor(float(jax.random.uniform(kr, (), jnp.float64)),
                     dtype=torch.float64)
    return js, ts, r


def _use_r(monkeypatch, r):
    """The port's resampling offset is the JAX draw."""
    for mod in (trs, resample_v2):
        monkeypatch.setattr(mod, "_uniform", lambda *a: r)


@pytest.mark.parametrize("which", ["plain", "advanced"])
@pytest.mark.parametrize("exact", [False, True], ids=["B", "E"])
def test_apf_predict_step_matches_jax(monkeypatch, which, exact):
    js, ts, r = _shared_state()
    _use_r(monkeypatch, r)
    pj, aj = _jax_filters()
    pt, at = _port_filters(exact_resample=exact)
    inner_j, inner_t = (pj, pt) if which == "plain" else (aj, at)
    apf_j = llpf.AuxiliaryParticleFilter(pf=inner_j)
    apf_t = llpt.AuxiliaryParticleFilter(pf=inner_t)
    u, y1 = np.array([0.3]), np.array([0.4, -0.2])
    oj = apf_j.predict(js, jnp.asarray(u), jnp.asarray(y1))
    ot = apf_t.predict(ts, torch.tensor(u), torch.tensor(y1))
    for name in ("x", "w", "we"):
        np.testing.assert_allclose(getattr(ot, name).numpy(),
                                   np.asarray(getattr(oj, name)),
                                   rtol=1e-10, atol=1e-12)
    assert ot.t == 1
    # the correct step only normalizes, and returns the same ll
    cj, ij = apf_j.correct(oj, jnp.asarray(u), jnp.asarray(y1))
    ct, it = apf_t.correct(ot, torch.tensor(u), torch.tensor(y1))
    np.testing.assert_allclose(float(it.ll), float(ij.ll), rtol=1e-12)


def test_advanced_pf_update_step_matches_jax(monkeypatch):
    """The advanced filter's correct (user likelihood) and its
    always-resampling predict."""
    js, ts, r = _shared_state(5)
    _use_r(monkeypatch, r)
    _, aj = _jax_filters()
    _, at = _port_filters()
    u, y = np.array([0.3]), np.array([0.4, -0.2])
    cj, ij = aj.correct(js, jnp.asarray(u), jnp.asarray(y))
    ct, it = at.correct(ts, torch.tensor(u), torch.tensor(y))
    np.testing.assert_allclose(float(it.ll), float(ij.ll), rtol=1e-12)
    np.testing.assert_allclose(ct.we.numpy(), np.asarray(cj.we), rtol=1e-10)
    # resample key: the JAX predict splits the state's key as the shared
    # state's r assumed
    oj = aj.predict(cj.replace(key=js.key), jnp.asarray(u))
    ot = at.predict(ct, torch.tensor(u))
    np.testing.assert_allclose(ot.x.numpy(), np.asarray(oj.x), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(ot.w.numpy(), np.asarray(oj.w), rtol=1e-12)


def test_advanced_pf_noise_dim():
    """The dynamics get ``noise_dim`` standard normals a particle (None
    for the noiseless propagation the APF's lookahead uses)."""
    seen = []

    def dyn(x, u, p, t, z):
        seen.append(None if z is None else tuple(z.shape))
        return x + (0 if z is None else 0.1 * z.sum())

    adv = convert.advanced_particle_filter_from_numpy(
        64, dyn, lambda x, u, p, t, z: x,
        lambda x, u, y, p, t: -((y - x) ** 2).sum(), np.eye(2), noise_dim=1,
        dtype=torch.float64, device="cpu")
    st = adv.init(torch.Generator().manual_seed(0))
    adv.predict(st, torch.zeros(1))
    llpt.AuxiliaryParticleFilter(pf=adv).predict(st, torch.zeros(1),
                                                  torch.zeros(2))
    assert seen == [(1,), None, (1,)]


@pytest.fixture(scope="module")
def linear_data():
    kf = convert.kalman_filter_from_numpy(A, B, C, 0, R1, R2, d0_cov=R1,
                                          device="cpu")
    u = torch.full((100, 1), 0.3, dtype=torch.float64)
    _, u, y = llpt.simulate(kf, u, torch.Generator().manual_seed(1))
    return kf, u, y, float(llpt.loglik(kf, u, y))


@pytest.mark.parametrize("which", ["apf", "advanced", "apf_exact"])
def test_ll_within_2pct_of_kf(linear_data, which):
    """N = 2000, T = 100; the KF starts from N(0, R1), as the filters do.
    The APF never scores y[0] (its correct step only normalizes, as in
    the reference), about 1 % of this ll."""
    kf, u, y, ll_kf = linear_data
    pf, adv = _port_filters(th=0.5, N=2000, noise=True,
                            exact_resample=which == "apf_exact")
    filt = adv if which == "advanced" else llpt.AuxiliaryParticleFilter(
        pf=pf)
    ll = filt.loglik(u, y, generator=torch.Generator().manual_seed(4))
    assert llpt.last_route("loglik") == "sequential"
    assert abs(float(ll) - ll_kf) < 0.02 * abs(ll_kf), (float(ll), ll_kf)
