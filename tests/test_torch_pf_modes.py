"""PyTorch port: kernel A's moments, segment and scalar-density modes
(kernels/pf_scan.py) against the JAX whole-scan PF kernel.

The JAX kernel runs in interpret mode with zero process noise and
resampling offset r = 0.5 (``force_kernel=True``, as tests/test_pf_scan.py
runs it); the port's plain twin runs with ``noise="none"``, the same
deterministic recursion.  Both get the same initial cloud.  f32, N = 512.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lowlevelparticlefilters_jl_tpu as llpf
from lowlevelparticlefilters_jl_tpu.ops.pallas import pf_scan as jpf
import lowlevelparticlefilters_jl_tpu_torch as llpt
from lowlevelparticlefilters_jl_tpu_torch import convert
from lowlevelparticlefilters_jl_tpu_torch.kernels import pf_scan

A = np.array([[0.97, -0.1], [0.1, 0.97]], np.float32)
B = np.array([[0.1], [0.0]], np.float32)
C = np.eye(2, dtype=np.float32)
R1z = 1e-12 * np.eye(2, dtype=np.float32)
R2 = 0.1 * np.eye(2, dtype=np.float32)
N = 512


def _pair(th, dm_jax=None, C_=C):
    """The same filter in both packages; ``dm_jax`` a JAX measurement
    density (default N(0, R2)), carried across by density_from_numpy."""
    Aj, Bj, Cj = (jnp.asarray(M, jnp.float32) for M in (A, B, C_))
    pj = llpf.ParticleFilter(
        N=N, dynamics=lambda x, u, p, t: Aj @ x + Bj @ u,
        measurement=lambda x, u, p, t: Cj @ x,
        dynamics_density=jnp.asarray(R1z),
        measurement_density=jnp.asarray(R2) if dm_jax is None else dm_jax,
        initial_density=llpf.MvNormal(jnp.zeros(2, jnp.float32),
                                      jnp.eye(2, dtype=jnp.float32)),
        resample_threshold=th)
    f, g = convert.linear_callbacks(A, B, C_, device="cpu")
    dm = None if dm_jax is None else convert.density_from_numpy(
        dm_jax, device="cpu")
    pt = convert.particle_filter_from_numpy(N, f, g, R1z, R2, np.eye(2),
                                            measurement_density=dm,
                                            resample_threshold=th,
                                            device="cpu")
    return pj, pt


def _data(T, seed=1):
    rng = np.random.default_rng(seed)
    x0 = rng.normal(size=(N, 2)).astype(np.float32)
    us = 0.3 * np.ones((T, 1), np.float32)
    ys = rng.normal(size=(T, 2)).astype(np.float32)
    return x0, us, ys


def _j(*a):
    return [jnp.asarray(v) for v in a]


def _t(*a):
    return [torch.tensor(v) for v in a]


@pytest.mark.parametrize("th,T,C_", [(0.0, 140, C), (1.0, 40, C)],
                         ids=["threshold0_T140", "threshold1_T40"])
def test_stats_match_jax_kernel(th, T, C_):
    """Means and central covariances of every step, and ll: threshold 0
    never resamples and crosses the JAX kernel's 128-step block; threshold
    1 resamples every step with r = 0.5 on both sides."""
    pj, pt = _pair(th, C_=C_)
    x0, us, ys = _data(T)
    mj, cj, llj, nj = jpf.pf_stats_fused(pj, *_j(us, ys), 0, x0=_j(x0)[0],
                                         force_kernel=True)
    mt, ct, llt, nt = llpt.pf_stats_fused(pt, *_t(us, ys), 0,
                                          x0=torch.tensor(x0), noise="none")
    assert mt.shape == (T, 2) and ct.shape == (T, 2, 2)
    assert float(nt) == float(nj) == (T if th >= 1 else 0)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=2e-4,
                               atol=1e-5)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=2e-4,
                               atol=1e-5)
    np.testing.assert_allclose(float(llt), float(llj), rtol=1e-5)
    # the means mode is the stats mode without the covariances
    m1, ll1, _ = llpt.pf_mean_fused(pt, *_t(us, ys), 0, x0=torch.tensor(x0),
                                    noise="none")
    assert torch.equal(m1, mt) and float(ll1) == float(llt)


def test_segment_matches_jax_kernel():
    """No resampling, local normalization, from given log-weights."""
    pj, pt = _pair(0.5)
    x0, us, ys = _data(60, seed=4)
    w0 = np.random.default_rng(5).normal(size=N).astype(np.float32)
    llj, xj, wj = jpf.pf_segment_fused(pj, *_j(us, ys), 0, *_j(x0, w0),
                                       force_kernel=True)
    llt, xt, wt = llpt.pf_segment_fused(pt, *_t(us, ys), 0, *_t(x0, w0),
                                        noise="none")
    assert xt.shape == (N, 2) and wt.shape == (N,)
    np.testing.assert_allclose(float(llt), float(llj), rtol=1e-5)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-5,
                               atol=1e-4)
    # the carried unnormalized weights: with no resampling, ll_local +
    # lse(w_fin) - lse(w0) is the loglik mode's ll from the normalized w0
    w0t = torch.tensor(w0)
    ll_full, _ = pf_scan.pf_loglik_scan_plain(
        *pf_scan.scan_inputs(pt, *_t(us, ys)), N=N, thresh=0.0, seed=0,
        noise="none", x0=torch.tensor(x0),
        w0=w0t - torch.logsumexp(w0t, 0))
    np.testing.assert_allclose(
        float(llt + torch.logsumexp(wt, 0) - torch.logsumexp(w0t, 0)),
        float(ll_full), rtol=1e-5)


@pytest.mark.parametrize("make_d", [
    lambda: llpf.TupleProduct([llpf.StudentT(3.0, 0.0, 0.3),
                               llpf.StudentT(5.0, 0.0, 0.3)]),
    lambda: llpf.TupleProduct([llpf.Laplace(0.0, 0.3),
                               llpf.MixtureNormal(0.9, 0.0, 0.3, 0.0, 3.0)]),
], ids=["studentt_studentt", "laplace_mixture"])
def test_scalar_density_matches_jax_kernel(make_d):
    """The two products of tests/test_pf_scan.py:291-308 in the weight
    phase, T = 140, no resampling."""
    pj, pt = _pair(0.0, make_d())
    assert jpf.pf_scan_supported(pj) and llpt.pf_scan_supported(pt)
    x0, us, ys = _data(140)
    llj, nj = jpf.pf_loglik_fused(pj, *_j(us, ys), 0, x0=_j(x0)[0],
                                  force_kernel=True)
    before = pf_scan.PF_DENSITY_SCAN.launches
    llt, nt = llpt.pf_loglik_fused(pt, *_t(us, ys), 0, x0=torch.tensor(x0),
                                   noise="none")
    assert pf_scan.PF_DENSITY_SCAN.launches == before  # the CPU twin
    assert float(nt) == float(nj) == 0.0
    np.testing.assert_allclose(float(llt), float(llj), rtol=1e-5)


def test_folded_constants_equal_the_densities():
    """The kernel's float64-folded constants give each family's logpdf
    (f32 twin against the float64 density)."""
    d = llpt.TupleProduct([
        llpt.Normal(0.2, 0.3), llpt.Uniform(-1.0, 2.0), llpt.Laplace(0.1, 0.4),
        llpt.StudentT(4.0, -0.1, 0.5), llpt.Binary(0.0, 1.0, 0.3),
        llpt.MixtureNormal(0.8, 0.1, 0.3, -0.2, 2.0)])
    e = torch.tensor(np.random.default_rng(2).normal(size=(64, 6)),
                     dtype=torch.float32)
    e[:, 4] = torch.tensor([0.0, 1.0, 0.5, 1.0 + 1e-6] * 16)
    e[::5, 1] = 3.0  # outside the uniform's support
    want = d.logpdf(e.double())
    got = pf_scan.scalar_logpdf_plain(*pf_scan.density_constants(d), e)
    fin = torch.isfinite(want)
    assert torch.equal(fin, torch.isfinite(got)) and (~fin).any()
    np.testing.assert_allclose(got[fin].numpy(), want[fin].numpy(),
                               rtol=1e-5, atol=1e-5)


def test_array_parameters_route_sequential():
    """A tensor parameter is refused by the kernel (its constants cannot
    be folded on the host) and ``last_route()`` says ``sequential``."""
    _, pt = _pair(0.1)
    dm = llpt.TupleProduct([llpt.StudentT(torch.tensor(3.0), 0.0, 0.3),
                            llpt.StudentT(3.0, 0.0, 0.3)])
    pt = pt.replace(measurement_density=dm)
    assert not llpt.pf_scan_supported(pt)
    _, us, ys = _data(8)
    g = torch.Generator().manual_seed(0)
    for fn in (lambda: pt.loglik(*_t(us, ys), generator=g, method="fused"),
               lambda: llpt.mean_trajectory(pt, *_t(us, ys), generator=g,
                                            method="fused")):
        assert torch.isfinite(fn()).all()
        assert llpt.last_route() == "sequential"
    with pytest.raises(ValueError, match="does not admit"):
        llpt.pf_mean_fused(pt, *_t(us, ys), 0)


def test_all_minus_inf_step_ends_as_sequential():
    """Uniform support that no particle meets at one step: every weight
    is -inf there, and the fused twin ends as the sequential route does,
    with a NaN ll."""
    dm = llpt.TupleProduct([llpt.Uniform(-50.0, 50.0),
                            llpt.Uniform(-50.0, 50.0)])
    _, pt = _pair(0.1)
    pt = pt.replace(measurement_density=dm)
    _, us, ys = _data(6)
    ys[3, 0] = 1000.0
    u, y = _t(us, ys)
    seq = pt.loglik(u, y, generator=torch.Generator().manual_seed(0),
                    method="sequential")
    fused = pt.loglik(u, y, generator=torch.Generator().manual_seed(0),
                      method="fused")
    assert llpt.last_route() == "fused_scan_plain"
    assert math.isnan(float(seq)) and math.isnan(float(fused))
    # one step earlier the same filter is finite on both routes
    ok = pt.loglik(u[:3], y[:3], generator=torch.Generator().manual_seed(0),
                   method="fused")
    assert math.isfinite(float(ok))


def test_repair_vector_densities_pass_through():
    """The filter keeps a vector density object as it is (a TupleProduct
    measurement density, as the JAX filter accepts); a covariance matrix
    still becomes a zero-mean Gaussian."""
    dm = llpt.TupleProduct([llpt.Laplace(0.0, 0.3), llpt.Normal(0.0, 0.3)])
    _, pt = _pair(0.1)
    pf = llpt.ParticleFilter(N=16, dynamics=pt.dynamics,
                             measurement=pt.measurement,
                             dynamics_density=torch.eye(2),
                             measurement_density=dm,
                             initial_density=torch.eye(2))
    assert pf.measurement_density is dm
    assert isinstance(pf.dynamics_density, llpt.MvNormal)


def test_repair_fused_entries_exported():
    import lowlevelparticlefilters_jl_tpu_torch.kernels.pf_scan as k

    for name in ("pf_loglik_fused", "pf_mean_fused", "pf_stats_fused",
                 "pf_segment_fused", "pf_scan_supported"):
        assert getattr(llpt, name) is getattr(k, name)
