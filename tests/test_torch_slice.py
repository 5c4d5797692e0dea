"""PyTorch port, the slice as a whole: the benchmark's model built in both
packages, the port's PF log-likelihood certified against its KF (which
equals the JAX KF), the routes taken, and an import that loads no JAX."""
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import A, B, C, R1, R2

import lowlevelparticlefilters_jl_tpu as llpf
import lowlevelparticlefilters_jl_tpu_torch as llpt
from lowlevelparticlefilters_jl_tpu_torch import convert
from lowlevelparticlefilters_jl_tpu_torch.kernels import pf_scan

T = 50


def _model(N, threshold=0.1, noise_backend="torch", device="cpu"):
    f, g = convert.linear_callbacks(A, B, C, device=device)
    pf = convert.particle_filter_from_numpy(
        N, f, g, R1, R2, R1, resample_threshold=threshold,
        noise_backend=noise_backend, device=device)
    kf = convert.kalman_filter_from_numpy(A, B, C, 0, R1, R2, device="cpu")
    return pf, kf


def _data(kf, T=T, seed=1):
    u = torch.full((T, 1), 0.3, dtype=torch.float64)
    _, u, y = llpt.simulate(kf, u, torch.Generator().manual_seed(seed))
    return u, y


@pytest.fixture(scope="module")
def headline():
    pf, kf = _model(4000)
    u, y = _data(kf)
    kj = llpf.KalmanFilter(*(jnp.asarray(M) for M in (A, B, C)), 0,
                           jnp.asarray(R1), jnp.asarray(R2))
    ll_jax = float(llpf.loglik(kj, jnp.asarray(u.numpy()),
                               jnp.asarray(y.numpy()), method="sequential"))
    return pf, kf, u, y, ll_jax


def test_kf_loglik_equals_jax(headline):
    _, kf, u, y, ll_jax = headline
    np.testing.assert_allclose(float(llpt.loglik(kf, u, y)), ll_jax,
                               rtol=1e-10)


@pytest.mark.parametrize("method", ["auto", "sequential", "fused"])
def test_pf_loglik_within_2pct_of_kf(headline, method):
    pf, kf, u, y, ll_jax = headline
    ll = pf.loglik(u.float(), y.float(), generator=torch.Generator()
                   .manual_seed(0), method=method)
    assert abs(float(ll) - ll_jax) < 0.02 * abs(ll_jax)
    want = "fused_scan_plain" if method == "fused" else "sequential"
    assert llpt.last_route() == want


@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_pf_forward_trajectory(headline, backend):
    _, kf, u, y, ll_jax = headline
    pf, _ = _model(4000, noise_backend=backend)
    sol = pf.forward_trajectory(u.float(), y.float(),
                                generator=torch.Generator().manual_seed(2))
    assert sol.x.shape == (T, 4000, 2) and sol.we.shape == (T, 4000)
    torch.testing.assert_close(sol.we.sum(-1), torch.ones(T))
    assert abs(float(sol.ll) - ll_jax) < 0.02 * abs(ll_jax)
    m = llpt.weighted_mean(sol.x, sol.we)
    assert m.shape == (T, 2) and bool(torch.isfinite(m).all())
    assert llpt.weighted_cov(sol.x, sol.we).shape == (T, 2, 2)


def test_route_by_admission(headline):
    """Out of kernel A's gate the verb takes the sequential route and
    says so: here a non-affine measurement and an f64 filter."""
    pf, _, u, y, _ = headline
    g = torch.Generator().manual_seed(0)
    nonlin = pf.replace(measurement=lambda x, u, p, t: torch.tanh(x))
    nonlin.loglik(u.float(), y.float(), generator=g, method="fused")
    assert llpt.last_route("loglik") == "sequential"
    pf64 = convert.particle_filter_from_numpy(
        100, *convert.linear_callbacks(A, B, C, dtype=torch.float64,
                                       device="cpu"), R1, R2,
        R1, dtype=torch.float64, device="cpu")
    pf64.loglik(u, y, generator=g, method="fused")
    assert llpt.last_route("loglik") == "sequential"
    assert pf_scan.kernel_admits(pf, u.float(), y.float()) is not None
    with pytest.raises(ValueError):
        pf.loglik(u.float(), y.float(), generator=g, method="nope")


def test_sequential_route_differentiates():
    pf, kf = _model(300)
    u, y = _data(kf, 10)
    R2p = torch.tensor(0.1 * np.eye(2), dtype=torch.float32,
                       requires_grad=True)
    pfg = pf.replace(measurement_density=llpt.MvNormal(torch.zeros(2), R2p))
    ll = pfg.loglik(u.float(), y.float(), generator=torch.Generator()
                    .manual_seed(0), method="sequential")
    ll.backward()
    assert R2p.grad is not None and bool(torch.isfinite(R2p.grad).all())


def test_import_loads_no_jax():
    code = ("import sys, lowlevelparticlefilters_jl_tpu_torch as m; "
            "import lowlevelparticlefilters_jl_tpu_torch.convert; "
            "import lowlevelparticlefilters_jl_tpu_torch.kernels.pf_scan; "
            "import lowlevelparticlefilters_jl_tpu_torch.filters.bank; "
            "import lowlevelparticlefilters_jl_tpu_torch.parallel.temporal; "
            "import lowlevelparticlefilters_jl_tpu_torch.parallel.bank; "
            "import lowlevelparticlefilters_jl_tpu_torch.kernels.bank_scan; "
            "import lowlevelparticlefilters_jl_tpu_torch.kernels.assoc_scan; "
            "print(any(k == 'jax' or k.startswith('jax.') "
            "for k in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "False"
