"""PyTorch port: the CUDA kernels against their plain twins, on the card.

Every test here needs a CUDA device and skips without one.  The file
imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch
from _torch_parity import (A, B, C, R1, R2, cuda_device,  # noqa: F401
                           lattice_case)

import lowlevelparticlefilters_jl_tpu_torch as llpt
from lowlevelparticlefilters_jl_tpu_torch import convert
from lowlevelparticlefilters_jl_tpu_torch.kernels import (noise, pf_scan,
                                                          resample_route)
from lowlevelparticlefilters_jl_tpu_torch.ops import resample as trs

pytestmark = pytest.mark.cuda


def test_philox_bits_match_plain_and_curand(cuda_device):
    ctr = torch.randint(0, 2**32, (4096, 4), dtype=torch.int64,
                        generator=torch.Generator().manual_seed(0))
    key = (0x01234567, 0x89ABCDEF)
    ref = noise.philox_bits(ctr, key)
    assert torch.equal(noise.philox_bits(ctr.to(cuda_device), key).cpu(), ref)
    assert torch.equal(noise.philox_bits(ctr.to(cuda_device), key,
                                         curand=True).cpu(), ref)


def test_normal_and_add_gaussian_noise(cuda_device):
    z = noise.normal(5, (200_000,), device=cuda_device)
    zp = noise.normal_plain(5, 200_000, device=cuda_device)
    assert float((z - zp).abs().max()) <= 1e-6
    xn = torch.randn(100_000, 2, device=cuda_device)
    chol = torch.tensor([[0.1, 0.0], [0.02, 0.1]], device=cuda_device)
    out = noise.add_gaussian_noise(xn, chol, 11, 3)
    ref = noise.add_gaussian_noise_plain(xn, chol, 11, 3)
    assert float((out - ref).abs().max()) <= 1e-6


@pytest.mark.parametrize("nx", [2, 4])
def test_systematic_gather_bitwise(cuda_device, nx):
    g = torch.Generator().manual_seed(nx)
    x = torch.randn(100_000, nx, generator=g)
    we = torch.rand(100_000, generator=g, dtype=torch.float64) ** 20
    K = trs._systematic_slots(we / we.sum(),
                              torch.tensor(0.37, dtype=torch.float64),
                              100_000)
    ref = resample_route.systematic_gather_plain(x, K)
    out = resample_route.systematic_gather(x.to(cuda_device),
                                           K.to(cuda_device))
    assert torch.equal(out.cpu(), ref)


def _model(N, device, threshold=0.1, C_=C):
    f, g = convert.linear_callbacks(A, B, C_, device=device)
    return convert.particle_filter_from_numpy(
        N, f, g, R1, R2, R1, resample_threshold=threshold, device=device)


def _data(T, seed=1):
    kf = convert.kalman_filter_from_numpy(A, B, C, 0, R1, R2)
    u = torch.full((T, 1), 0.3, dtype=torch.float64)
    _, u, y = llpt.simulate(kf, u, torch.Generator().manual_seed(seed))
    return kf, u, y


def test_pf_kernel_matches_plain_without_noise(cuda_device):
    pf = _model(100_000, cuda_device, threshold=0.0)
    _, u, y = _data(200)
    x0 = torch.randn(100_000, 2, generator=torch.Generator().manual_seed(0),
                     ).to(cuda_device)
    args = pf_scan.scan_inputs(pf, u.float().to(cuda_device),
                               y.float().to(cuda_device))
    kw = dict(N=pf.N, thresh=0.0, seed=0, noise="none", x0=x0)
    llk, nk = pf_scan.pf_loglik_scan(*args, **kw)
    llp, npl = pf_scan.pf_loglik_scan_plain(*args, **kw)
    np.testing.assert_allclose(float(llk), float(llp), rtol=1e-5)
    assert float(nk) == float(npl) == 0.0


def test_pf_kernel_resampling_is_exact(cuda_device):
    """Kernel A against its plain twin where the resampling selection is
    not the identity: in the lattice case every weight is 0 or 1, so the
    sums, the quantized weights, K and the gathered clouds are the same
    in any order, and ll and the resample count must be equal."""
    pf, u, y, x0 = lattice_case(100_000, 200, device=cuda_device)
    args = pf_scan.scan_inputs(pf, u, y)
    kw = dict(N=pf.N, thresh=float(pf.resample_threshold), seed=0,
              noise="none", x0=x0)
    llk, nk = pf_scan.pf_loglik_scan(*args, **kw)
    llp, npl = pf_scan.pf_loglik_scan_plain(*args, **kw)
    assert 1.0 <= float(npl) < 200.0
    assert float(nk) == float(npl)
    assert float(llk) == float(llp)


def test_main_path_on_card(cuda_device):
    pf = _model(100_000, cuda_device)
    kf, u, y = _data(200)
    ll_kf = float(llpt.loglik(kf, u, y))
    before = pf_scan.PF_LOGLIK_SCAN.launches
    ll = pf.loglik(u.float().to(cuda_device), y.float().to(cuda_device),
                   generator=torch.Generator(device=cuda_device)
                   .manual_seed(0))
    assert llpt.last_route() == "cuda_fused_scan"
    assert pf_scan.PF_LOGLIK_SCAN.launches == before + 1
    assert abs(float(ll) - ll_kf) < 0.01 * abs(ll_kf)
