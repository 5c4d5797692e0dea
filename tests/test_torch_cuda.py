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
from lowlevelparticlefilters_jl_tpu_torch.filters import bank as tbank
from lowlevelparticlefilters_jl_tpu_torch.kernels import (
    assoc_scan, bank_scan, noise, pf_scan, resample_route)
from lowlevelparticlefilters_jl_tpu_torch.ops import resample as trs

pytestmark = pytest.mark.cuda


def test_builders_default_to_the_card(cuda_device):
    kf = convert.kalman_filter_from_numpy(A, B, C, 0, R1, R2)
    f, _ = convert.linear_callbacks(A, B, C)
    pf = convert.particle_filter_from_numpy(10, f, f, R1, R2, R1)
    assert kf.A.is_cuda and kf.d0.cov.is_cuda
    assert pf.initial_density.mean.is_cuda
    assert noise.normal(0, (4,)).is_cuda
    assert noise.NORMAL.launches >= 1


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
    kf = convert.kalman_filter_from_numpy(A, B, C, 0, R1, R2, device="cpu")
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


def _psd(g, T, nx, scale):
    h = 0.3 * torch.randn(T, nx, nx, generator=g)
    return h @ h.mT + scale * torch.eye(nx)


def _elements(kind, T, nx, seed):
    g = torch.Generator().manual_seed(seed)
    if kind == assoc_scan.FILTER:
        el = (0.3 * torch.randn(T, nx, nx, generator=g),
              torch.randn(T, nx, generator=g), _psd(g, T, nx, 0.1),
              torch.randn(T, nx, generator=g), _psd(g, T, nx, 0.1))
    else:  # E contracting at every nx, so long products stay finite
        el = (0.4 * min(1.0, (2 / nx) ** 0.5)
              * torch.randn(T, nx, nx, generator=g),
              torch.randn(T, nx, generator=g), _psd(g, T, nx, 0.0))
    return el


@pytest.mark.parametrize("kind", [0, 1])
@pytest.mark.parametrize("nx,T", [(2, 1), (2, 15), (2, 16), (2, 17),
                                  (2, 257), (2, 4097), (1, 3000),
                                  (3, 3000), (8, 3000)])
def test_assoc_scan_matches_twin(cuda_device, kind, nx, T):
    """Kernel K against its Hillis–Steele twin on the same elements,
    rtol 2e-4, atol 2e-5 (f32 in another association order); T crosses
    the 16-step chunks and the levels of the recursion."""
    el = _elements(kind, T, nx, seed=T + nx)
    run = assoc_scan.filter_scan if kind == 0 else assoc_scan.smooth_scan
    ref = run(*el)
    before = assoc_scan.ASSOC_SCAN.launches
    out = run(*(e.to(cuda_device) for e in el))
    assert assoc_scan.ASSOC_SCAN.launches == before + 1
    for o, r in zip(out, ref):
        torch.testing.assert_close(o.cpu(), r, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("Bk,T,nu,shared", [(1024, 200, 1, False),
                                            (37, 70, 1, True),
                                            (300, 65, 0, False)])
def test_bank_kernel_matches_twin(cuda_device, Bk, T, nu, shared):
    """Kernel F against its plain twin on the card, rtol 2e-5, atol 1e-4
    (f32; the kernel contracts multiply-adds); T crosses the 64-step
    staging of the scalars, B a partial block."""
    kf = convert.kalman_filter_from_numpy(
        A, B if nu else None, C, 0, R1, R2, dtype=torch.float32,
        device=cuda_device)
    g = torch.Generator().manual_seed(Bk)
    ys = torch.randn(Bk, T, 2, generator=g).to(cuda_device)
    us = (0.3 * torch.randn(T, nu, generator=g).to(cuda_device)
          [None].expand(Bk, T, nu) if shared
          else 0.3 * torch.randn(Bk, T, nu, generator=g).to(cuda_device))
    _, Sch, K, _, Am, Bm, Cm, Dm = tbank._shared_recursion(
        kf, T, torch.float32, cuda_device)
    scal, _ = bank_scan.bank_scalars(Sch, K, Am, Bm, Cm, Dm, nu)
    x0 = kf.d0.mean.float().contiguous()
    before = bank_scan.BANK_LOGLIK.launches
    got = bank_scan.bank_loglik_scan(scal, ys, us, x0, 2, 2, nu)
    assert bank_scan.BANK_LOGLIK.launches == before + 1
    want = bank_scan.bank_loglik_scan_plain(scal, ys, us, x0, 2, 2, nu)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=1e-4)


def test_bank_and_parallel_routes_on_card(cuda_device):
    """kf_bank_loglik takes kernels K and F once each; the KF verbs at
    T >= 256 take kernel K; both agree with the f64 CPU results."""
    kf64, u, y = _data(1000)
    kf = convert.kalman_filter_from_numpy(A, B, C, 0, R1, R2,
                                          dtype=torch.float32,
                                          device=cuda_device)
    uc, yc = u.float().to(cuda_device), y.float().to(cuda_device)
    k0 = assoc_scan.ASSOC_SCAN.launches
    ll = llpt.loglik(kf, uc, yc)
    assert llpt.last_route() == "cuda_temporal_parallel"
    assert assoc_scan.ASSOC_SCAN.launches == k0 + 1
    ll_ref = float(llpt.loglik(kf64, u, y))
    assert abs(float(ll) - ll_ref) < 1e-4 * abs(ll_ref)
    sm = llpt.parallel_rts_smooth(kf, uc, yc)
    assert assoc_scan.ASSOC_SCAN.launches == k0 + 3
    sm_ref = llpt.parallel_rts_smooth(kf64, u, y)
    torch.testing.assert_close(sm.xT.cpu().double(), sm_ref.xT, rtol=1e-3,
                               atol=1e-4)

    ys = torch.stack([y, -y, 0.5 * y] * 100)[:, :200].float().to(cuda_device)
    us = u[:200].float().to(cuda_device)[None].expand(300, 200, 1)
    f0 = bank_scan.BANK_LOGLIK.launches
    k0 = assoc_scan.ASSOC_SCAN.launches
    lls = llpt.kf_bank_loglik(kf, us, ys)
    assert llpt.last_route("kf_bank_loglik") == "cuda_bank_kernel"
    assert bank_scan.BANK_LOGLIK.launches == f0 + 1
    assert assoc_scan.ASSOC_SCAN.launches == k0 + 1
    ref = llpt.kf_bank_loglik(kf64, us[:3].cpu().double(),
                              ys[:3].cpu().double(), method="plane")
    torch.testing.assert_close(lls[:3].cpu().double(), ref, rtol=1e-4,
                               atol=0.0)
