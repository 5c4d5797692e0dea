"""PyTorch port: UT weights, sigma points and the UT moments against the
JAX package, float64, for all three weight schemes and L = 1..8 (the
same formulas, so to 1e-12)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import np_of

import lowlevelparticlefilters_jl_tpu as llpf
import lowlevelparticlefilters_jl_tpu_torch as llpt
from lowlevelparticlefilters_jl_tpu_torch.ops.linalg import blkdiag

SCHEMES = {
    "trivial": (llpf.TrivialParams(), llpt.TrivialParams()),
    "wiki": (llpf.WikiParams(alpha=0.8, beta=2.0, kappa=1.5),
             llpt.WikiParams(alpha=0.8, beta=2.0, kappa=1.5)),
    "merwe": (llpf.MerweParams(alpha=0.5, beta=2.0, kappa=0.1),
              llpt.MerweParams(alpha=0.5, beta=2.0, kappa=0.1)),
}
TOL = dict(rtol=1e-12, atol=1e-12)


def _psd(rng, L):
    h = rng.normal(size=(L, L))
    return h @ h.T + 0.5 * np.eye(L)


@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_weights_sigmapoints_and_moments(scheme):
    pj, pt = SCHEMES[scheme]
    rng = np.random.default_rng(len(scheme))
    for L in range(1, 9):
        wj, wt = llpf.ukf_weights(pj, L), llpt.ukf_weights(pt, L)
        np.testing.assert_allclose(
            [wt.wm, wt.wc, wt.wmi, wt.wci, wt.W],
            [wj.wm, wj.wc, wj.wmi, wj.wci, wj.W], **TOL)
        m, S = rng.normal(size=L), _psd(rng, L)
        xj = llpf.sigmapoints(jnp.asarray(m), jnp.asarray(S), pj)
        xt = llpt.sigmapoints(torch.tensor(m), torch.tensor(S), pt)
        np.testing.assert_allclose(np_of(xt), np_of(xj), **TOL)
        ys = np.sin(np_of(xt))[:, :min(L, 3)]
        mj = llpf.ut_mean(jnp.asarray(ys), wj)
        mt = llpt.ut_mean(torch.tensor(ys), wt)
        np.testing.assert_allclose(np_of(mt), np_of(mj), **TOL)
        np.testing.assert_allclose(
            np_of(llpt.ut_cov(torch.tensor(ys), mt, wt)),
            np_of(llpf.ut_cov(jnp.asarray(ys), mj, wj)), **TOL)
        np.testing.assert_allclose(
            np_of(llpt.ut_cross_cov(xt, torch.tensor(m), torch.tensor(ys),
                                    mt, wt)),
            np_of(llpf.ut_cross_cov(xj, jnp.asarray(m), jnp.asarray(ys),
                                    mj, wj)), **TOL)


def test_parameter_checks_and_blkdiag():
    for cls in (llpt.WikiParams, llpt.MerweParams):
        with pytest.raises(ValueError):
            cls(alpha=-1.0)
        assert cls.from_ak(0.5).alpha == 0.5 and cls.from_ak(2.0).kappa == 2.0
    with pytest.raises(TypeError):
        llpt.ukf_weights(object(), 2)
    a, b = torch.ones(2, 2), 2 * torch.ones(1, 1)
    want = torch.tensor([[1.0, 1, 0], [1, 1, 0], [0, 0, 2]])
    assert torch.equal(blkdiag(a, b), want)
