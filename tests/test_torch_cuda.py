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
    assoc_scan, bank_scan, ffbs, noise, pf_scan, resample_route, resample_v2,
    ukf_scan)
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


def _model(N, device, threshold=0.1, C_=C, backend="torch"):
    f, g = convert.linear_callbacks(A, B, C_, device=device)
    return convert.particle_filter_from_numpy(
        N, f, g, R1, R2, R1, resample_threshold=threshold,
        noise_backend=backend, device=device)


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


# ---------------------------------------------------------------------------
# Kernels G, H and I (kernels/ukf_scan.py)
# ---------------------------------------------------------------------------

DT = 0.1
CV_A = np.array([[1, 0, DT, 0], [0, 1, 0, DT], [0, 0, 1, 0], [0, 0, 0, 1.0]])
CV_B = np.array([[0, 0], [0, 0], [DT, 0], [0, DT]])
CV_C = np.array([[1, 0, 0, 0], [0, 1, 0, 0.0]])


def _close_solution(got, want, rtol=2e-4, atol=1e-5):
    """ll within 1e-5 relative; the solution fields within the JAX tests'
    trajectory bounds (tests/test_ukf_fused.py:139)."""
    (llg, og), (llw, ow) = got, want
    assert abs(float(llg) - float(llw)) <= 1e-5 * abs(float(llw))
    for name, a, b in zip(ukf_scan._FIELDS, og or (), ow or ()):
        torch.testing.assert_close(a.cpu(), b.cpu(), rtol=rtol, atol=atol,
                                   msg=name)


def _t32(a, dev):
    return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)


def _cv_filters(dev, nonlinear=False, user_jac=False):
    A, Bm, C = (_t32(M, dev) for M in (CV_A, CV_B, CV_C))
    R1, R2 = 0.1 * torch.eye(4, device=dev), torch.eye(2, device=dev)
    d0 = llpt.MvNormal(torch.zeros(4, device=dev), 0.5 * torch.eye(4,
                                                                  device=dev))
    if nonlinear:
        f = lambda x, u, p, t: A @ x + 0.01 * torch.sin(x)  # noqa: E731
        jac = dict(Ajac=lambda x, u, p, t: A + 0.01 * torch.diag(torch.cos(x)),
                   Cjac=lambda x, u, p, t: C) if user_jac else {}
        return llpt.make_ekf(f, lambda x, u, p, t: C @ x, R1, R2, d0=d0,
                             nu=0, ny=2, **jac)
    return llpt.make_ekf(lambda x, u, p, t: A @ x + Bm @ u,
                         lambda x, u, p, t: C @ x, R1, R2, d0=d0, nu=2, ny=2)


def _quadtank(dev):
    g1 = lambda x: torch.sqrt(torch.abs(x) + 0.1)  # noqa: E731

    def dyn(x, u, p, t):
        return x + 0.1 * torch.stack([-g1(x[0]) + 0.5 * g1(x[1]),
                                      -0.5 * g1(x[1]) + 0.1])

    return llpt.make_ukf(dyn, lambda x, u, p, t: x,
                         1e-3 * torch.eye(2, device=dev),
                         1e-2 * torch.eye(2, device=dev), ny=2, nu=0,
                         d0=llpt.MvNormal(torch.ones(2, device=dev),
                                          0.1 * torch.eye(2, device=dev)))


def _angle_ukf(dev):
    wrap = lambda a: torch.remainder(a + np.pi, 2 * np.pi) - np.pi  # noqa

    def dyn(x, u, p, t):
        return torch.stack([wrap(x[0] + 0.1 * x[1]), 0.98 * x[1]])

    def smean(xs, W):
        w = torch.cat([xs.new_full((1,), W.wm),
                       xs.new_full((xs.shape[0] - 1,), W.wmi)])
        return torch.stack([wrap((w * xs[:, 0]).sum()), (w * xs[:, 1]).sum()])

    mm = llpt.UKFMeasurementModel(
        measurement=lambda x, u, p, t: x[:1],
        R2=0.05 * torch.eye(1, device=dev), ny=1,
        innovation=lambda y, yh: wrap(y - yh))
    return llpt.UnscentedKalmanFilter(
        dynamics=dyn, measurement_model=mm,
        R1=torch.diag(torch.tensor([0.01, 0.001], device=dev)), nu=0,
        state_mean=smean)


@pytest.mark.parametrize("T", [1, 130, 300])
def test_akf_kernel_matches_twin(cuda_device, T):
    """Kernel H against its twin (freeze included), ll and solution, with
    both drives, one, and none (not read); T crosses the 128-step staging
    chunks."""
    ekf = _cv_filters(cuda_device)
    g = torch.Generator().manual_seed(T)
    ys = torch.randn(T, 2, generator=g).to(cuda_device)
    us = 0.3 * torch.randn(T, 2, generator=g).to(cuda_device)
    A, C = ukf_scan._const_affine_kf_params(ekf, ekf.measurement_model, 4)
    cs, ds = ukf_scan.drives(ekf, us, T, cuda_device)
    gauss = ukf_scan._gaussian_inputs(ekf, cuda_device)
    for drives in ((cs, ds), (cs, None), (None, None)):
        args = (ys, *drives, *gauss, A, C, 1.01)
        for traj in (False, True):
            before = ukf_scan.AKF_SCAN.launches
            got = ukf_scan.akf_scan(*args, traj=traj)
            assert ukf_scan.AKF_SCAN.launches == before + 1
            _close_solution(got, ukf_scan.akf_scan_plain(*args, traj=traj))


@pytest.mark.parametrize("user_jac", [False, True])
def test_ekf_kernel_matches_twin(cuda_device, user_jac):
    ekf = _cv_filters(cuda_device, nonlinear=True, user_jac=user_jac)
    ys = torch.randn(300, 2, generator=torch.Generator().manual_seed(3)
                     ).to(cuda_device)
    for traj in (False, True):
        before = ukf_scan.EKF_SCAN.launches
        got = ukf_scan.ekf_scan(ekf, ys, traj=traj)
        assert ukf_scan.EKF_SCAN.launches == before + 1
        _close_solution(got, ukf_scan.ekf_scan_plain(ekf, ys, traj=traj))


@pytest.mark.parametrize("case", ["quadtank", "cv", "angle"])
def test_ukf_kernel_matches_twin(cuda_device, case):
    if case == "quadtank":
        ukf = _quadtank(cuda_device)
        ys = 1.0 + 0.1 * torch.randn(300, 2, generator=torch.Generator()
                                     .manual_seed(4)).to(cuda_device)
    elif case == "cv":
        A, C = _t32(CV_A, cuda_device), _t32(CV_C, cuda_device)
        ukf = llpt.make_ukf(lambda x, u, p, t: A @ x,
                            lambda x, u, p, t: C @ x,
                            0.1 * torch.eye(4, device=cuda_device),
                            torch.eye(2, device=cuda_device), ny=2, nu=0)
        ys = torch.randn(300, 2, generator=torch.Generator().manual_seed(5)
                         ).to(cuda_device)
    else:
        ukf = _angle_ukf(cuda_device)
        ang = torch.cumsum(0.12 * torch.ones(300), 0) - 2.0
        ys = (torch.remainder(ang + np.pi, 2 * np.pi) - np.pi)[:, None]
        ys = (ys + 0.1 * torch.randn(300, 1, generator=torch.Generator()
                                     .manual_seed(6))).to(cuda_device)
    for traj in (False, True):
        before = ukf_scan.UKF_SCAN.launches
        got = ukf_scan.ukf_scan(ukf, ys, traj=traj)
        assert ukf_scan.UKF_SCAN.launches == before + 1
        _close_solution(got, ukf_scan.ukf_scan_plain(ukf, ys, traj=traj))


def test_generated_kernel_second_call_builds_nothing(cuda_device):
    from lowlevelparticlefilters_jl_tpu_torch.kernels import _lib

    ekf = _cv_filters(cuda_device, nonlinear=True)
    ys = torch.randn(50, 2, generator=torch.Generator().manual_seed(7)
                     ).to(cuda_device)
    llpt.loglik(ekf, None, ys)
    assert llpt.last_route() == "cuda_fused_scan"
    builds, before = len(_lib.GEN_BUILDS), ukf_scan.EKF_SCAN.launches
    llpt.loglik(ekf, None, ys)
    llpt.forward_trajectory(ekf, None, ys)
    assert len(_lib.GEN_BUILDS) == builds
    assert ukf_scan.EKF_SCAN.launches == before + 2


def test_refused_launch_raises(cuda_device):
    """A launch the kernel refuses is an error, and so is an input that
    requires grad."""
    from lowlevelparticlefilters_jl_tpu_torch.kernels import _lib

    z = torch.zeros(4, device=cuda_device)
    p = z.data_ptr()
    with pytest.raises(RuntimeError, match="CUDA error"):
        _lib.check(_lib.library().lib.llpf_akf_scan(
            p, p, p, p, p, p, p, p, p, 1.0, 1, 9, 1, p, *[None] * 7,
            _lib.stream_ptr(z)), "akf_scan")
    ekf = _cv_filters(cuda_device, nonlinear=True)
    ys = torch.zeros(5, 2, device=cuda_device, requires_grad=True)
    with pytest.raises(RuntimeError, match="requires grad"):
        ukf_scan.ekf_scan(ekf, ys)


def test_ukf_ekf_kf_routes_on_card(cuda_device):
    """The main paths' routes: KF loglik_fused and method="fused" take H;
    the affine CV UKF without force takes H, not G; the nonlinear EKF and
    the quadtank UKF under "auto" take I and G; all within 1e-4 of the
    float64 CPU sequential recursion."""
    T = 400
    ys = torch.randn(T, 2, generator=torch.Generator().manual_seed(8))
    kf = convert.kalman_filter_from_numpy(CV_A, None, CV_C, 0,
                                          0.1 * np.eye(4), np.eye(2),
                                          dtype=torch.float32,
                                          device=cuda_device)
    kf64 = convert.kalman_filter_from_numpy(CV_A, None, CV_C, 0,
                                            0.1 * np.eye(4), np.eye(2),
                                            device="cpu")
    ref = float(llpt.loglik(kf64, None, ys.double(), method="sequential"))
    yc = ys.to(cuda_device)
    counts = lambda: (ukf_scan.AKF_SCAN.launches,  # noqa: E731
                      ukf_scan.UKF_SCAN.launches, ukf_scan.EKF_SCAN.launches)
    h0, g0, i0 = counts()
    for ll in (kf.loglik_fused(yc), llpt.loglik(kf, None, yc,
                                                method="fused")):
        assert llpt.last_route() == "cuda_fused_scan"
        assert abs(float(ll) - ref) < 1e-4 * abs(ref)
    A, C = _t32(CV_A, cuda_device), _t32(CV_C, cuda_device)
    ukf = llpt.make_ukf(lambda x, u, p, t: A @ x, lambda x, u, p, t: C @ x,
                        kf.R1, kf.R2, ny=2, nu=0)
    assert abs(float(llpt.ukf_loglik_fused(ukf, yc)) - ref) < 1e-4 * abs(ref)
    assert counts() == (h0 + 3, g0, i0)
    llpt.loglik(_cv_filters(cuda_device, nonlinear=True), None, yc)
    assert llpt.last_route() == "cuda_fused_scan"
    llpt.loglik(_quadtank(cuda_device), None, 1.0 + 0.1 * yc)
    assert llpt.last_route() == "cuda_fused_scan"
    assert counts() == (h0 + 3, g0 + 1, i0 + 1)


# ---- FFBS (kernel J), the smoothers, kernel A's admission, reproducibility


def _ffbs_inputs(dev, T, N, M, nx, seed, shift=10.0):
    """Whitened inputs of kernel J (clouds away from the origin, every
    97th column of weight -inf), and the seeds's arguments."""
    g = torch.Generator().manual_seed(seed)
    xf = shift + torch.randn(T - 1, N, nx, generator=g)
    xpred = 0.97 * xf + 0.1 * torch.randn(T - 1, N, nx, generator=g)
    wf = torch.randn(T - 1, N, generator=g)
    wf[:, ::97] = float("-inf")
    xb_T = shift + torch.randn(M, nx, generator=g)
    L = torch.linalg.cholesky(0.02 * torch.eye(nx) + 0.01)
    mu = 0.01 * torch.arange(nx, dtype=torch.float32)
    zpred, wfc, c, Linv = ffbs.whiten(xpred.to(dev), wf.to(dev), L.to(dev))
    return zpred, wfc, c, xf.to(dev), xb_T.to(dev), Linv, mu.to(dev)


@pytest.mark.parametrize("nx,T,N,M", [(1, 5, 37, 5), (2, 20, 1000, 64),
                                      (3, 6, 4099, 33), (8, 4, 300, 16)])
def test_ffbs_kernel_matches_twin(cuda_device, nx, T, N, M):
    """Kernel J against its twin on the same inputs: the MAP columns
    (no noise) exactly, and with the same Philox stream at most 0.1 % of
    the (t, m) draws apart (a near-tie broken by a one-ulp difference;
    expected none: the kernel rounds every operation as the twin does);
    never a -inf column; every row a forward particle."""
    args = _ffbs_inputs(cuda_device, T, N, M, nx, seed=nx)
    xf = args[3]
    for noise_on in (False, True):
        before = ffbs.FFBS_BACKWARD.launches
        out, idx = ffbs.ffbs_backward_scan(*args, 123, noise=noise_on,
                                           return_indices=True)
        assert ffbs.FFBS_BACKWARD.launches == before + 1
        ref, ridx = ffbs.ffbs_backward_plain(*args, 123, noise=noise_on,
                                             return_indices=True)
        if noise_on:
            assert float((idx != ridx).float().mean()) <= 1e-3
        else:
            assert torch.equal(idx, ridx) and torch.equal(out, ref)
        assert not bool((idx % 97 == 0).any())
        for t in range(T - 1):
            assert torch.equal(out[t], xf[t][idx[t].long()])
        assert torch.equal(out[-1], args[4])


def test_ffbs_kernel_refuses(cuda_device):
    args = list(_ffbs_inputs(cuda_device, 3, 50, 4, 2, seed=0))
    args[4] = args[4].clone().requires_grad_()
    with pytest.raises(RuntimeError, match="requires grad"):
        ffbs.ffbs_backward_scan(*args, 0)
    args = _ffbs_inputs(cuda_device, 3, 50, 4, 9, seed=0)
    with pytest.raises(ValueError, match="nx"):
        ffbs.ffbs_backward_scan(*args, 0)


def _rms_z(xb, kf, u, y):
    """RMS over steps and states of (FFBS smoothed mean - RTS mean) /
    sqrt(RTS variance), against the float64 CPU smoother of the exact
    KF."""
    ssol = llpt.rts_smooth(llpt.forward_trajectory(kf, u, y), kf)
    z = (llpt.smoothed_mean(xb).double().cpu() - ssol.xT) / torch.diagonal(
        ssol.RT, dim1=-2, dim2=-1).sqrt()
    return float(z.square().mean().sqrt())


def test_pf_smooth_on_card(cuda_device):
    """``pf.smooth`` on CUDA tensors: one launch of kernel J, kernels B, C
    and D in the forward pass, and a smoothed mean within 0.4 RTS
    deviations (RMS) of the exact smoother: the plain loop gives 0.15-0.24
    here (N = 1000 particles, M = 500 trajectories), a selection off by
    one column about 1.5."""
    pf = _model(1000, cuda_device, backend="kernel")
    kf, u, y = _data(100, seed=4)
    counts = lambda: (ffbs.FFBS_BACKWARD.launches,  # noqa: E731
                      resample_route.SYSTEMATIC_GATHER.launches,
                      noise.NORMAL.launches,
                      noise.ADD_GAUSSIAN_NOISE.launches)
    before = counts()
    xb, ll = pf.smooth(u.float().to(cuda_device), y.float().to(cuda_device),
                       M=500, generator=torch.Generator(device=cuda_device)
                       .manual_seed(0))
    assert llpt.last_route("smooth") == "cuda_ffbs_kernel"
    after = counts()
    assert after[0] == before[0] + 1
    assert all(a > b for a, b in zip(after[1:], before[1:]))
    assert xb.shape == (100, 500, 2) and bool(torch.isfinite(ll))
    assert _rms_z(xb, kf, u, y) < 0.4


def test_clamped_pf_routes_sequential_on_card(cuda_device):
    """Kernel A's admission walks the callbacks: a clamp to ±5 that the
    probes cannot see routes sequential; the unclamped filter takes A."""
    pf = _model(10_000, cuda_device)
    At, Bt = (torch.tensor(M, dtype=torch.float32, device=cuda_device)
              for M in (A, B))
    clamped = pf.replace(dynamics=lambda x, u, p, t: torch.clamp(
        At @ x + Bt @ u, -5.0, 5.0))
    _, u, y = _data(20)
    uc, yc = u.float().to(cuda_device), y.float().to(cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    before = pf_scan.PF_LOGLIK_SCAN.launches
    clamped.loglik(uc, yc, generator=g)
    assert llpt.last_route("loglik") == "sequential"
    assert pf_scan.PF_LOGLIK_SCAN.launches == before
    pf.loglik(uc, yc, generator=g)
    assert llpt.last_route("loglik") == "cuda_fused_scan"
    assert pf_scan.PF_LOGLIK_SCAN.launches == before + 1


def test_cumsum_has_one_order_on_card(cuda_device):
    """The resampling cumsum gives the same bits call after call, and
    agrees with PyTorch's to float32 rounding."""
    we = torch.rand(100_000, generator=torch.Generator().manual_seed(1)
                    ).to(cuda_device) ** 8
    first = trs._cumsum(we)
    for _ in range(20):
        assert torch.equal(trs._cumsum(we), first)
    torch.testing.assert_close(first, torch.cumsum(we, 0), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_pf_forward_trajectory_reproducible_on_card(cuda_device, backend):
    """Two seeded calls of the unfused PF forward pass give the same
    particles, weights and ll, bit for bit, resampling included."""
    pf = _model(100_000, cuda_device, backend=backend)
    _, u, y = _data(50, seed=5)
    uc, yc = u.float().to(cuda_device), y.float().to(cuda_device)
    before = resample_route.SYSTEMATIC_GATHER.launches
    sols = [pf.forward_trajectory(uc, yc, generator=torch.Generator(
        device=cuda_device).manual_seed(7)) for _ in range(2)]
    assert resample_route.SYSTEMATIC_GATHER.launches >= before + 2
    for f in ("x", "w", "we", "ll"):
        assert torch.equal(getattr(sols[0], f), getattr(sols[1], f)), f


def test_smooth_routes_on_card(cuda_device):
    """``smooth`` on CUDA tensors at T = 300: the KF takes
    ``parallel_rts_smooth``, the quadtank UKF ``parallel_ukf_smooth`` and
    the ``A x + 0.01 sin x`` EKF ``parallel_iekf_smooth`` (kernel K), each
    within rtol 1e-3, atol 1e-4 of the same function run in float64 on
    the CPU; ``method="sequential"`` and ``ukf.smooth(fused=True)`` (one
    launch of kernel G) likewise against their float64 CPU runs."""
    T = 300
    tol = dict(rtol=1e-3, atol=1e-4)
    kf, u, y = _data(T, seed=6)
    kf32 = convert.kalman_filter_from_numpy(A, B, C, 0, R1, R2,
                                            dtype=torch.float32,
                                            device=cuda_device)
    uc, yc = u.float().to(cuda_device), y.float().to(cuda_device)
    ref = llpt.smooth(kf, u, y, method="sequential")
    for method in ("auto", "sequential"):
        got = llpt.smooth(kf32, uc, yc, method=method)
        assert llpt.last_route("smooth") == (
            "cuda_temporal_parallel" if method == "auto" else "sequential")
        torch.testing.assert_close(got.xT.double().cpu(), ref.xT, **tol)
        torch.testing.assert_close(got.RT.double().cpu(), ref.RT, **tol)
    q32, q64 = _quadtank(cuda_device), _quadtank("cpu")
    q64 = q64.replace(R1=q64.R1.double(), d0=llpt.MvNormal(
        q64.d0.mean.double(), q64.d0.cov.double()),
        measurement_model=q64.measurement_model.replace(
            R2=q64.measurement_model.R2.double()))
    yq = 1.0 + 0.1 * torch.randn(T, 2, generator=torch.Generator()
                                 .manual_seed(9), dtype=torch.float64)
    e32 = _cv_filters(cuda_device, nonlinear=True)
    ye = torch.randn(T, 2, generator=torch.Generator().manual_seed(10),
                     dtype=torch.float64)
    for f32, f64, yy in ((q32, q64, yq), (e32, None, ye)):
        got = llpt.smooth(f32, None, yy.float().to(cuda_device))
        assert llpt.last_route("smooth") == "cuda_temporal_parallel"
        assert bool(torch.isfinite(got.xT).all())
        if f64 is not None:
            want = llpt.smooth(f64, None, yy, method="parallel")
            torch.testing.assert_close(got.xT.double().cpu(), want.xT, **tol)
    g0 = ukf_scan.UKF_SCAN.launches
    got = q32.smooth(None, yq.float().to(cuda_device), fused=True)
    assert ukf_scan.UKF_SCAN.launches == g0 + 1
    want = q64.smooth(None, yq)
    torch.testing.assert_close(got.xT.double().cpu(), want.xT, **tol)


# ---- PF state tracking: kernel A's moments, segment and scalar-density
# modes, kernel E -------------------------------------------------------------


def _mode_case(cuda_device, kind, N=100_000, T=200, dm=None):
    """Inputs of kernel A and the keywords of one comparison case:
    "none" (no noise, threshold 0), "philox" (the same Philox stream,
    threshold 0: no resampling, so only the sum order differs) or
    "lattice" (exact resampling, tests/_torch_parity.py)."""
    if kind == "lattice":
        pf, u, y, x0 = lattice_case(N, T, device=cuda_device)
        kw = dict(N=N, thresh=float(pf.resample_threshold), seed=0,
                  noise="none", x0=x0)
        return pf_scan.scan_inputs(pf, u, y), kw, pf
    pf = _model(N, cuda_device, threshold=0.0)
    if dm is not None:
        pf = pf.replace(measurement_density=dm)
    _, u, y = _data(T)
    x0 = torch.randn(N, 2, generator=torch.Generator().manual_seed(0)
                     ).to(cuda_device)
    kw = dict(N=N, thresh=0.0, seed=3, noise=kind, x0=x0)
    return (pf_scan.scan_inputs(pf, u.float().to(cuda_device),
                                y.float().to(cuda_device)), kw, pf)


@pytest.mark.parametrize("kind", ["none", "philox", "lattice"])
def test_pf_moments_mode_matches_twin(cuda_device, kind):
    """Means and central covariances against the twin, rtol 2e-4 and atol
    1e-5 (the sums run in another order); ll at 1e-5 and the resample
    count exactly (in the lattice case the means, sums of multiples of 8
    under 2^24, are exact too)."""
    args, kw, _ = _mode_case(cuda_device, kind)
    before = pf_scan.PF_MOMENTS_SCAN.launches
    got = pf_scan.pf_scan(*args, moments=2, **kw)
    assert pf_scan.PF_MOMENTS_SCAN.launches == before + 1
    want = pf_scan.pf_scan_plain(*args, moments=2, **kw)
    assert float(got["nres"]) == float(want["nres"])
    np.testing.assert_allclose(float(got["ll"]), float(want["ll"]),
                               rtol=1e-5)
    for name in ("means", "covs"):
        torch.testing.assert_close(got[name], want[name], rtol=2e-4,
                                   atol=1e-5)
    if kind == "lattice":
        assert 1.0 <= float(want["nres"]) < 200.0
        assert torch.equal(got["means"], want["means"])
    # the means mode writes the same means and no covariances
    one = pf_scan.pf_scan(*args, moments=1, **kw)
    assert "covs" not in one and torch.equal(one["means"], got["means"])


@pytest.mark.parametrize("kind", ["none", "philox"])
def test_pf_segment_mode_matches_twin(cuda_device, kind):
    args, kw, _ = _mode_case(cuda_device, kind, T=100)
    w0 = torch.randn(kw["N"], generator=torch.Generator().manual_seed(1)
                     ).to(cuda_device)
    before = pf_scan.PF_SEGMENT_SCAN.launches
    got = pf_scan.pf_scan(*args, w0=w0, segment=True, **kw)
    assert pf_scan.PF_SEGMENT_SCAN.launches == before + 1
    want = pf_scan.pf_scan_plain(*args, w0=w0, segment=True, **kw)
    assert float(got["nres"]) == float(want["nres"]) == 0.0
    np.testing.assert_allclose(float(got["ll"]), float(want["ll"]),
                               rtol=1e-5)
    torch.testing.assert_close(got["x_fin"], want["x_fin"], rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(got["w_fin"], want["w_fin"], rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("kind", ["none", "philox"])
def test_pf_density_mode_matches_twin(cuda_device, kind):
    dm = llpt.TupleProduct([llpt.StudentT(4.0, 0.0, 0.35),
                            llpt.Laplace(0.0, 0.25)])
    args, kw, pf = _mode_case(cuda_device, kind, dm=dm)
    dens = pf_scan.scan_density(pf, cuda_device)
    before = pf_scan.PF_DENSITY_SCAN.launches
    llk, nk = pf_scan.pf_loglik_scan(*args, dens=dens, **kw)
    assert pf_scan.PF_DENSITY_SCAN.launches == before + 1
    llp, npl = pf_scan.pf_loglik_scan_plain(*args, dens=dens, **kw)
    np.testing.assert_allclose(float(llk), float(llp), rtol=1e-5)
    assert float(nk) == float(npl) == 0.0


def test_pf_density_all_minus_inf_on_card(cuda_device):
    """A step where no particle meets the uniform support: the kernel's
    ll is NaN, as the sequential route's is."""
    dm = llpt.TupleProduct([llpt.Uniform(-50.0, 50.0),
                            llpt.Uniform(-50.0, 50.0)])
    pf = _model(20_000, cuda_device).replace(measurement_density=dm)
    _, u, y = _data(8)
    y[4, 0] = 1000.0
    uc, yc = u.float().to(cuda_device), y.float().to(cuda_device)
    g = torch.Generator(device=cuda_device)
    ll = pf.loglik(uc, yc, generator=g.manual_seed(0))
    assert llpt.last_route("loglik") == "cuda_fused_scan"
    seq = pf.loglik(uc, yc, generator=g.manual_seed(0), method="sequential")
    assert np.isnan(float(ll)) and np.isnan(float(seq))


@pytest.mark.parametrize("nx", [2, 8])
@pytest.mark.parametrize("profile", ["random", "skewed", "single"])
def test_index_gather_bitwise(cuda_device, nx, profile):
    """Kernel E against its twin: j and the rows bitwise, f32 and f64."""
    g = torch.Generator().manual_seed(nx)
    N = 100_000
    we = torch.rand(N, generator=g, dtype=torch.float64)
    if profile == "skewed":
        we = we ** 20
    elif profile == "single":
        we = torch.zeros(N, dtype=torch.float64)
        we[12345] = 1.0
    K = trs._systematic_slots(we / we.sum(),
                              torch.tensor(0.37, dtype=torch.float64), N)
    for dtype in (torch.float32, torch.float64):
        x = torch.randn(N, nx, generator=g, dtype=dtype)
        out_p, j_p = resample_v2.systematic_index_gather_plain(x, K)
        before = resample_v2.SYSTEMATIC_INDEX_GATHER.launches
        out, j = resample_v2.systematic_index_gather(x.to(cuda_device),
                                                     K.to(cuda_device))
        assert resample_v2.SYSTEMATIC_INDEX_GATHER.launches == before + 1
        assert j.dtype == torch.int32
        assert torch.equal(j.cpu(), j_p) and torch.equal(out.cpu(), out_p)
    if profile == "single":
        assert bool((j == 12345).all())


def test_pf_tracking_routes_on_card(cuda_device):
    """``mean_trajectory`` takes kernel A's moments mode; the
    ``exact_resample`` filter takes kernel E and gives the bits of the
    default filter; the APF resamples through B (or E)."""
    pf = _model(20_000, cuda_device)
    kf, u, y = _data(60, seed=3)
    uc, yc = u.float().to(cuda_device), y.float().to(cuda_device)
    g = torch.Generator(device=cuda_device)
    before = pf_scan.PF_MOMENTS_SCAN.launches
    m = llpt.mean_trajectory(pf, uc, yc, generator=g.manual_seed(0))
    assert llpt.last_route("mean_trajectory") == "cuda_fused_scan"
    assert pf_scan.PF_MOMENTS_SCAN.launches == before + 1
    assert m.shape == (60, 2) and bool(torch.isfinite(m).all())
    sols = []
    e0 = resample_v2.SYSTEMATIC_INDEX_GATHER.launches
    for exact in (True, False):
        sols.append(pf.replace(exact_resample=exact).forward_trajectory(
            uc, yc, generator=g.manual_seed(1)))
    resamples = int((1.0 / (sols[0].we ** 2).sum(-1) < 0.1 * pf.N).sum())
    assert resamples >= 1
    assert resample_v2.SYSTEMATIC_INDEX_GATHER.launches == e0 + resamples
    for f in ("x", "w", "we", "ll"):
        assert torch.equal(getattr(sols[0], f), getattr(sols[1], f)), f
    b0 = resample_route.SYSTEMATIC_GATHER.launches
    apf = llpt.AuxiliaryParticleFilter(pf=pf)
    ll = apf.loglik(uc, yc, generator=g.manual_seed(2))
    assert resample_route.SYSTEMATIC_GATHER.launches == b0 + 59
    ll_kf = float(llpt.loglik(kf, u, y))
    assert abs(float(ll) - ll_kf) < 0.05 * abs(ll_kf)
