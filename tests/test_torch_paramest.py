"""PyTorch port: ``paramest.py`` against the JAX package on the same numpy
inputs in float64.

- ``prediction_errors`` (both modes, ``offset``), ``sse``-weighted
  residuals and the residuals' Jacobian (``torch.func.jacfwd`` and
  ``jacrev`` against ``jax.jacfwd``): rtol 1e-10, the same recursion.
- ``autotune_covariances`` in its diagonal, full, ``optimize_x0`` and MAP
  forms at T = 100, ``iters`` = 10: θ and ``info["cost"]`` to 1e-6 (ten
  LM steps amplify the residuals' last-ulp differences).
- ``metropolis`` fed the JAX package's own proposal increments and
  uniforms (rebuilt from its key splits): the same chain to 1e-10.
- ``metropolis_parallel``'s shape, ``log_likelihood_fun``'s -inf map,
  ``triangular``/``invtriangular``, ``reconstruct_filter``.

Each JAX result is computed once per module."""
import math
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import A, B, C, R1, R2, np_of

import lowlevelparticlefilters_jl_tpu as llpf
import lowlevelparticlefilters_jl_tpu_torch as llpt
from lowlevelparticlefilters_jl_tpu_torch import convert

T = 100
RTOL = dict(rtol=1e-10, atol=1e-12)
D0M, D0C = np.array([0.5, -0.2]), 2.0 * np.eye(2)
OFFSET = 5.0
FORMS = {"diagonal": dict(), "full": dict(diagonal=False),
         "x0": dict(optimize_x0=True), "map": dict(v_R1=50.0, v_R2=50.0)}


def _kf_pair(R1_=R1, R2_=R2):
    kj = llpf.KalmanFilter(jnp.asarray(A), jnp.asarray(B), jnp.asarray(C), 0,
                           jnp.asarray(R1_), jnp.asarray(R2_),
                           d0=llpf.MvNormal(jnp.asarray(D0M),
                                            jnp.asarray(D0C)))
    kt = convert.kalman_filter_from_numpy(A, B, C, 0, R1_, R2_, D0M, D0C,
                                          device="cpu")
    return kj, kt


def _data():
    """The model's data (a numpy simulation, so both packages read it)."""
    rng = np.random.default_rng(0)
    u = 0.3 + 0.1 * rng.normal(size=(T, 1))
    x, y = rng.multivariate_normal(D0M, D0C), np.empty((T, 2))
    for k in range(T):
        y[k] = C @ x + rng.multivariate_normal(np.zeros(2), R2)
        x = A @ x + B @ u[k] + rng.multivariate_normal(np.zeros(2), R1)
    return u, y


def _jax_autotune(name):
    u, y = _data()
    start = (R1, R2) if name == "map" else (10 * R1, 0.05 * R2)
    kj, _ = _kf_pair(*start)
    return llpf.autotune_covariances(kj, jnp.asarray(u), jnp.asarray(y),
                                     iters=10, offset=OFFSET,
                                     **FORMS[name])[1]


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX package's results of this module, one future each, computed
    in a thread while the port's run: most of their time is XLA
    compiling, which releases the interpreter lock.  The thread has ended
    when the module does."""
    jobs = {f"autotune_{name}": (_jax_autotune, name) for name in FORMS}
    jobs["chain"] = (_jax_chain,)
    jobs["jacobian"] = (_jax_jacobian,)
    with ThreadPoolExecutor(max_workers=1) as pool:
        yield {k: pool.submit(*job) for k, job in jobs.items()}


@pytest.mark.parametrize("form", list(FORMS))
def test_autotune_covariances_matches_jax(jax_refs, form):
    u, y = _data()
    start = (R1, R2) if form == "map" else (10 * R1, 0.05 * R2)
    _, kt = _kf_pair(*start)
    f_opt, info = llpt.autotune_covariances(kt, torch.tensor(u),
                                            torch.tensor(y), iters=10,
                                            offset=OFFSET, **FORMS[form])
    want = jax_refs[f"autotune_{form}"].result()
    assert set(info) == set(want)
    np.testing.assert_allclose(np_of(info["theta"]), np_of(want["theta"]),
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(info["cost"], float(want["cost"]), rtol=1e-6)
    for key in ("R1", "R2", "x0"):
        np.testing.assert_allclose(np_of(info[key]), np_of(want[key]),
                                   rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(info["neg_loglik"], float(want["neg_loglik"]),
                               rtol=1e-6)
    assert llpt.last_route("prediction_errors") == "sequential"
    np.testing.assert_allclose(np_of(f_opt.R2), np_of(info["R2"]))


@pytest.mark.parametrize("mode", ["plain", "matrix_lam", "loglik"])
def test_prediction_errors_match_jax(mode):
    kj, kt = _kf_pair()
    u, y = _data()
    kw = {"plain": dict(lam=2.0),
          "matrix_lam": dict(lam=np.array([[2.0, 0.5], [0.5, 1.0]])),
          "loglik": dict(loglik=True, offset=OFFSET)}[mode]
    kwj = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    got = llpt.prediction_errors(kt, torch.tensor(u), torch.tensor(y), **kw)
    want = llpf.prediction_errors(kj, jnp.asarray(u), jnp.asarray(y), **kwj)
    np.testing.assert_allclose(np_of(got), np_of(want), **RTOL)
    if mode == "loglik":  # ‖res‖² = −ll + T·offset
        ll = float(llpt.loglik(kt, torch.tensor(u), torch.tensor(y)))
        np.testing.assert_allclose(float((got ** 2).sum()),
                                   -ll + T * OFFSET, rtol=1e-12)


TJ = 40
TH0 = np.log(np.array([0.02, 0.01, 0.1, 0.2]))


def _jax_jacobian():
    kj, _ = _kf_pair()
    u, y = _data()
    uj, yj = jnp.asarray(u[:TJ]), jnp.asarray(y[:TJ])

    def res_j(th):
        f = llpf.reconstruct_filter(kj, jnp.diag(jnp.exp(th[:2])),
                                    jnp.diag(jnp.exp(th[2:])), th[:2])
        return llpf.prediction_errors(f, uj, yj, loglik=True, offset=OFFSET)

    return jax.jacfwd(res_j)(jnp.asarray(TH0))


def test_residual_jacobian_matches_jax(jax_refs):
    """The residuals of a reconstructed filter as a function of the
    log-diagonals: ``torch.func.jacfwd`` (and the ``jacrev`` that the LM
    loop takes) against ``jax.jacfwd``, through the whole recursion."""
    _, kt = _kf_pair()
    u, y = _data()
    ut, yt = torch.tensor(u[:TJ]), torch.tensor(y[:TJ])

    def res_t(th):
        f = llpt.reconstruct_filter(kt, torch.diag(torch.exp(th[:2])),
                                    torch.diag(torch.exp(th[2:])), th[:2])
        return llpt.prediction_errors(f, ut, yt, loglik=True, offset=OFFSET)

    fwd = torch.func.jacfwd(res_t)(torch.tensor(TH0))
    rev = torch.func.jacrev(res_t)(torch.tensor(TH0))
    want = jax_refs["jacobian"].result()
    np.testing.assert_allclose(np_of(fwd), np_of(want), **RTOL)
    np.testing.assert_allclose(np_of(rev), np_of(want), **RTOL)


def test_triangular_and_reconstruct_filter():
    x = np.arange(1.0, 7.0)
    Tt, Tj = llpt.triangular(torch.tensor(x)), llpf.triangular(jnp.asarray(x))
    np.testing.assert_array_equal(np_of(Tt), np_of(Tj))
    np.testing.assert_array_equal(np_of(llpt.invtriangular(Tt)), x)
    _, kt = _kf_pair()
    k2 = llpt.reconstruct_filter(kt, 2 * torch.tensor(R1),
                                 3 * torch.tensor(R2), torch.zeros(2))
    assert torch.equal(k2.R1, 2 * kt.R1) and torch.equal(k2.R2, 3 * kt.R2)
    assert torch.equal(k2.d0.mean, torch.zeros(2))
    assert torch.equal(k2.d0.cov, kt.d0.cov) and torch.equal(k2.A, kt.A)
    # a UKF keeps R2 in its measurement model
    ukf = llpt.make_ukf(kt.dynamics_fn(), kt.measurement_fn(), kt.R1, kt.R2,
                        kt.d0, nu=1, ny=2)
    u2 = llpt.reconstruct_filter(ukf, kt.R1, 3 * kt.R2)
    assert torch.equal(u2.measurement_model.R2, 3 * kt.R2)
    assert type(u2) is type(ukf)


def _scale_filter(pkg, kf):
    """θ -> the KF with R1 and R2 scaled by exp(θ) (``pkg`` is jnp or
    torch)."""
    if pkg is jnp:
        return lambda th: llpf.reconstruct_filter(
            kf, jnp.exp(th[1]) * kf.R1, jnp.exp(th[0]) * kf.R2)
    return lambda th: llpt.reconstruct_filter(
        kf, torch.exp(th[1]) * kf.R1, torch.exp(th[0]) * kf.R2)


R_CHAIN, TH_CHAIN, T_CHAIN = 25, np.array([0.3, -0.2]), 50


def _jax_chain():
    """JAX's chain, and its draws rebuilt from its key splits: ``k0, key =
    split(key)``, one key an iteration, each split in three (proposal,
    uniform, ll)."""
    kj, _ = _kf_pair()
    u, y = _data()
    llj = llpf.log_likelihood_fun(_scale_filter(jnp, kj),
                                  [llpf.Normal(0.0, 1.0)] * 2,
                                  jnp.asarray(u[:T_CHAIN]),
                                  jnp.asarray(y[:T_CHAIN]))
    key = jax.random.PRNGKey(3)
    thj, lj = llpf.metropolis(llj, R_CHAIN, jnp.asarray(TH_CHAIN), key=key)
    _, key = jax.random.split(key)
    std = 0.1 * np.abs(TH_CHAIN)
    incs, unis = [], []
    for k in jax.random.split(key, R_CHAIN - 1):
        kd, ka, _ = jax.random.split(k, 3)
        incs.append(std * np.asarray(jax.random.normal(kd, (2,),
                                                       jnp.float64)))
        unis.append(float(jax.random.uniform(ka, (), jnp.float64)))
    return np_of(thj), np_of(lj), incs, unis


def test_metropolis_matches_jax_chain(jax_refs):
    """The port's chain fed JAX's increments and uniforms is JAX's chain."""
    _, kt = _kf_pair()
    u, y = _data()
    llt = llpt.log_likelihood_fun(_scale_filter(torch, kt),
                                  [llpt.Normal(0.0, 1.0)] * 2,
                                  torch.tensor(u[:T_CHAIN]),
                                  torch.tensor(y[:T_CHAIN]))
    thj, lj, incs, unis = jax_refs["chain"].result()
    it = iter(incs)
    tht, lt = llpt.metropolis(
        llt, R_CHAIN, torch.tensor(TH_CHAIN),
        draw=lambda th, g: th + torch.tensor(next(it)), uniforms=unis)
    np.testing.assert_allclose(np_of(tht), thj, **RTOL)
    np.testing.assert_allclose(np_of(lt), lj, **RTOL)
    assert 0 < int((tht[1:] != tht[:-1]).any(-1).sum()) < R_CHAIN - 1


def test_metropolis_parallel_and_log_likelihood_fun():
    _, kt = _kf_pair()
    u, y = _data()
    ll = llpt.log_likelihood_fun(_scale_filter(torch, kt),
                                 [llpt.Normal(0.0, 1.0)] * 2,
                                 torch.tensor(u[:20]), torch.tensor(y[:20]))
    g = torch.Generator().manual_seed(1)
    out = llpt.metropolis_parallel(3, ll, 8, torch.tensor(
        [0.3, -0.2], dtype=torch.float64), generator=g, n_chains=2)
    assert out.shape == ((8 - 3) * 2, 3)
    for row in out[::4]:
        np.testing.assert_allclose(float(ll(row[:2])), float(row[2]),
                                   **RTOL)
    assert not torch.equal(out[:5], out[5:])
    # a chain count the mesh does not divide is refused, as in JAX (the
    # mesh form itself runs in tests/test_torch_sharded.py)
    import types

    with pytest.raises(ValueError, match="divisible by the mesh size 3"):
        llpt.metropolis_parallel(0, ll, 4, torch.tensor([0.3, -0.2]),
                                 n_chains=2,
                                 mesh=types.SimpleNamespace(size=3, rank=0))
    with pytest.raises(ValueError):
        llpt.naive_sampler(torch.tensor([0.0, 1.0]))
    # a filter that breaks down maps to -inf, in both packages
    kj, _ = _kf_pair()
    bad_t = llpt.log_likelihood_fun(
        lambda th: llpt.reconstruct_filter(kt, kt.R1, -kt.R2), [],
        torch.tensor(u[:5]), torch.tensor(y[:5]))
    bad_j = llpf.log_likelihood_fun(
        lambda th: llpf.reconstruct_filter(kj, kj.R1, -kj.R2), [],
        jnp.asarray(u[:5]), jnp.asarray(y[:5]))
    assert float(bad_t(torch.zeros(1))) == float(bad_j(jnp.zeros(1))) \
        == -math.inf
