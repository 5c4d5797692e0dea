"""PyTorch port: ops/{logsumexp,mvnormal,linalg}.py against the JAX
package in float64 (rtol 1e-12: the same formulas, so only the last
ulps may differ)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import np_of

from lowlevelparticlefilters_jl_tpu.ops import linalg as jl
from lowlevelparticlefilters_jl_tpu.ops import logsumexp as jlse
from lowlevelparticlefilters_jl_tpu.ops import mvnormal as jmv
from lowlevelparticlefilters_jl_tpu_torch.ops import linalg as tl
from lowlevelparticlefilters_jl_tpu_torch.ops import logsumexp as tlse
from lowlevelparticlefilters_jl_tpu_torch.ops import mvnormal as tmv

RTOL = 1e-12


def _spd(rng, n):
    X = rng.normal(size=(n, n))
    return X @ X.T + n * np.eye(n)


def _close(a, b, rtol=RTOL):
    np.testing.assert_allclose(np_of(a), np_of(b), rtol=rtol, atol=1e-14)


def test_logsumexp_normalize():
    w = np.random.default_rng(0).normal(scale=5.0, size=1000)
    wj, wej, llj = jlse.logsumexp_normalize(jnp.asarray(w, jnp.float64))
    wt, wet, llt = tlse.logsumexp_normalize(torch.tensor(w))
    _close(wj, wt)
    _close(wej, wet)
    _close(llj, llt)


def test_logsumexp_and_expnormalize():
    w = np.random.default_rng(1).normal(scale=3.0, size=(4, 50))
    _close(jlse.logsumexp(jnp.asarray(w)), tlse.logsumexp(torch.tensor(w)))
    _close(jlse.expnormalize(jnp.asarray(w)),
           tlse.expnormalize(torch.tensor(w)))


def test_effective_particles():
    we = np.random.default_rng(2).uniform(size=777) ** 5
    we /= we.sum()
    _close(jlse.effective_particles(jnp.asarray(we)),
           tlse.effective_particles(torch.tensor(we)))


@pytest.mark.parametrize("n", [1, 2, 5, 10])
def test_chol_and_logdet(n):
    S = _spd(np.random.default_rng(n), n)
    Lj = jl.chol_lower(jnp.asarray(S))
    Lt = tl.chol_lower(torch.tensor(S))
    _close(Lj, Lt)
    _close(jl.logdet_chol(Lj), tl.logdet_chol(Lt))


@pytest.mark.parametrize("n", [2, 4, 9])
def test_tri_solve_and_rdiv_chol(n):
    rng = np.random.default_rng(10 + n)
    L = np.linalg.cholesky(_spd(rng, n))
    Bm = rng.normal(size=(n, 3))
    for lower in (True, False):
        Lx = L if lower else L.T
        _close(jl.tri_solve(jnp.asarray(Lx), jnp.asarray(Bm), lower=lower),
               tl.tri_solve(torch.tensor(Lx), torch.tensor(Bm), lower=lower))
    Bt = rng.normal(size=(3, n))
    _close(jl.rdiv_chol(jnp.asarray(Bt), jnp.asarray(L)),
           tl.rdiv_chol(torch.tensor(Bt), torch.tensor(L)))
    X = rng.normal(size=(n, n))
    _close(jl.symmetrize(jnp.asarray(X)), tl.symmetrize(torch.tensor(X)))


@pytest.mark.parametrize("k", [1, 2, 3])
def test_mvnormal_logpdf_and_chol(k):
    rng = np.random.default_rng(20 + k)
    mean, cov = rng.normal(size=k), _spd(rng, k)
    x = rng.normal(size=(64, k))
    dj = jmv.MvNormal(jnp.asarray(mean), jnp.asarray(cov))
    dt = tmv.MvNormal(torch.tensor(mean), torch.tensor(cov))
    _close(dj.chol(), dt.chol())
    _close(dj.logpdf(jnp.asarray(x)), dt.logpdf(torch.tensor(x)))
    _close(dj.logpdf(jnp.asarray(x[0])), dt.logpdf(torch.tensor(x[0])))


def test_as_mvnormal_conventions():
    cov = np.diag([1.0, 2.0])
    dt = tmv.as_mvnormal(torch.tensor(cov))
    assert torch.equal(dt.mean, torch.zeros(2, dtype=torch.float64))
    dv = tmv.as_mvnormal(torch.tensor([1.0, 2.0], dtype=torch.float64))
    assert torch.equal(dv.cov, torch.tensor(cov))


def test_mvnormal_sample_uses_generator():
    d = tmv.MvNormal(torch.zeros(2), torch.eye(2))
    a = d.sample(torch.Generator().manual_seed(3), (5,))
    b = d.sample(torch.Generator().manual_seed(3), (5,))
    assert a.shape == (5, 2) and torch.equal(a, b)
