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
    cov, mean = chol @ chol.T, torch.tensor([0.3, -0.1], device=cuda_device)
    seed = torch.tensor(11, device=cuda_device)
    out = noise.add_gaussian_noise(xn, cov, mean, seed, 3)
    ref = noise.add_gaussian_noise_plain(xn, cov, mean, seed, 3)
    assert float((out - ref).abs().max()) <= 1e-6


@pytest.mark.parametrize("n", [1, 3, 4, 5, 200_001])
def test_normal_tails_and_offset_view(cuda_device, n):
    """Kernel C's whole groups of four and its ragged tail, into a fresh
    tensor through the wrapper and, through the C entry, into a view at a
    4-byte offset: the twin's stream within 1e-6; the wrapper's launch
    counted."""
    from lowlevelparticlefilters_jl_tpu_torch.kernels import _lib

    zp = noise.normal_plain(9, n, tag=noise.TAG_INIT, device=cuda_device)
    before = noise.NORMAL.launches
    z = noise.normal(9, (n,), tag=noise.TAG_INIT, device=cuda_device)
    assert noise.NORMAL.launches == before + 1 and z.shape == (n,)
    buf = torch.full((n + 1,), 7.0, device=cuda_device)
    _lib.check(_lib.library().lib.llpf_normal(
        buf.data_ptr() + 4, n, 9, noise.TAG_INIT, 0, _lib.stream_ptr(buf)),
        "normal")
    assert float(buf[0]) == 7.0
    for got in (z, buf[1:]):
        assert float((got - zp).abs().max()) <= 1e-6


def _gather_weights(profile, N, g):
    """U^20 weights, or the skewed cloud B's merge-path split is for: one
    heavy particle and long stretches of particles with no offspring."""
    we = torch.rand(N, generator=g, dtype=torch.float64)
    if profile == "U^20":
        return we ** 20
    we = torch.where(torch.arange(N) % 5000 < 4000, 0.0, 1e-6 * we)
    we[N // 3] = 1.0
    return we


@pytest.mark.parametrize("N", [100_000, (1 << 24) + 1])
@pytest.mark.parametrize("profile", ["U^20", "heavy"])
@pytest.mark.parametrize("nx", [2, 4])
def test_systematic_gather_bitwise(cuda_device, nx, profile, N):
    """Kernel B against the plain gather on the same K, bitwise, float32
    and float64 rows: the K of E's slot stage at N = 1e5, of ``_cumsum``
    beyond E's N (2^24 + 1); one launch a call."""
    g = torch.Generator().manual_seed(nx)
    we = _gather_weights(profile, N, g).to(cuda_device)
    K = trs._systematic_slots(we / we.sum(), torch.tensor(
        0.37, dtype=torch.float64, device=cuda_device), N)
    for dtype in (torch.float32, torch.float64):
        x = torch.randn(N, nx, generator=g, dtype=dtype).to(cuda_device)
        ref = resample_route.systematic_gather_plain(x, K)
        before = resample_route.SYSTEMATIC_GATHER.launches
        out = resample_route.systematic_gather(x, K)
        assert resample_route.SYSTEMATIC_GATHER.launches == before + 1
        assert torch.equal(out, ref)


def _cumsum_resample(x, we, r):
    """The plain path of systematic resampling on the card: ``_cumsum``'s
    slot boundaries (the CPU arithmetic, in a fixed order), searchsorted
    and indexing; returns ``(x[j], j)``."""
    N = we.shape[0]
    bins = trs._cumsum(we)
    K = torch.ceil(bins * N / bins[-1:] - r).to(torch.int32)
    K = torch.cummax(K, 0).values.clamp(0, N)
    j = resample_route.slot_sources(K)
    return x[j], j


@pytest.mark.parametrize("N,dtype", [((1 << 24) + 1, torch.float32),
                                     ((1 << 24) + 1, torch.float64),
                                     (4096, torch.float16)])
def test_systematic_resampling_beyond_kernel_e(cuda_device, N, dtype):
    """Weights kernel E does not take (N above 2^24, float16) resample on
    the card through ``_cumsum``'s K and kernel B's gather:
    ``resample_systematic``, ``resample_systematic_gather``,
    ``fused_systematic_gather``, ``resample_gather`` with ``exact`` False
    and True and the PF's resample step give the cloud and ``j`` of the
    plain path on the same card, bitwise, and launch no E."""
    from lowlevelparticlefilters_jl_tpu_torch.filters.particle import PFState

    g = torch.Generator(device=cuda_device).manual_seed(N)
    x = torch.randn(N, 2, generator=g, device=cuda_device)
    we = torch.rand(N, generator=g, device=cuda_device,
                    dtype=torch.float64) ** 20
    we = (we / we.sum()).to(dtype)
    r = torch.rand((), generator=g, device=cuda_device, dtype=dtype)
    want_x, want_j = _cumsum_resample(x, we, r)
    e0 = (resample_v2.SYSTEMATIC_RESAMPLE.launches,
          resample_v2.SYSTEMATIC_SLOTS.launches)
    b0 = resample_route.SYSTEMATIC_GATHER.launches
    assert torch.equal(trs.resample_systematic(we, r=r), want_j)
    assert torch.equal(trs.resample_systematic_gather(x, we, r=r), want_x)
    got_x, got_j = resample_v2.fused_systematic_gather(x, we, r=r)
    assert got_j.dtype == torch.int32
    assert torch.equal(got_x, want_x) and torch.equal(got_j.long(), want_j)
    gen = torch.Generator(device=cuda_device)
    r = torch.rand((), generator=gen.manual_seed(5), device=cuda_device,
                   dtype=dtype)
    want_x, _ = _cumsum_resample(x, we, r)
    pf = _model(N, cuda_device, threshold=1.0)
    for exact in (False, True):
        assert torch.equal(trs.resample_gather(
            x, we, gen.manual_seed(5), exact=exact), want_x)
        state = PFState(x=x, w=we.log(), we=we, t=0,
                        generator=gen.manual_seed(5))
        xr, did = pf.replace(exact_resample=exact)._maybe_resample(state)
        assert did and torch.equal(xr, want_x)
    assert (resample_v2.SYSTEMATIC_RESAMPLE.launches,
            resample_v2.SYSTEMATIC_SLOTS.launches) == e0
    assert resample_route.SYSTEMATIC_GATHER.launches == b0 + 6


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


@pytest.mark.parametrize("N", [100, 1000, 100_003, 1_000_000])
def test_pf_kernel_sizes_match_twin(cuda_device, N):
    """Kernel A below one block of particles, at N not a multiple of the
    block, and at N = 1e6, against its twin: never resampling (no noise;
    the sums in another order, rtol 1e-5), always resampling with a
    state-free measurement (the identity selection, rtol 1e-5), each with
    its resample count exact; and the lattice case, ll exactly equal."""
    T = 50
    _, u, y = _data(T)
    uc, yc = u.float().to(cuda_device), y.float().to(cuda_device)
    x0 = torch.randn(N, 2, generator=torch.Generator().manual_seed(0)
                     ).to(cuda_device)
    for thresh, C_, nres in ((0.0, C, 0.0), (1.0, np.zeros((2, 2)), T)):
        pf = _model(N, cuda_device, threshold=thresh, C_=C_)
        args = pf_scan.scan_inputs(pf, uc, yc)
        kw = dict(N=N, thresh=thresh, seed=0, noise="none", x0=x0)
        llk, nk = pf_scan.pf_loglik_scan(*args, **kw)
        llp, npl = pf_scan.pf_loglik_scan_plain(*args, **kw)
        assert float(nk) == float(npl) == nres
        np.testing.assert_allclose(float(llk), float(llp), rtol=1e-5)
    pf, u4, y4, x04 = lattice_case(N, T, device=cuda_device)
    args = pf_scan.scan_inputs(pf, u4, y4)
    kw = dict(N=N, thresh=float(pf.resample_threshold), seed=0,
              noise="none", x0=x04)
    llk, nk = pf_scan.pf_loglik_scan(*args, **kw)
    llp, npl = pf_scan.pf_loglik_scan_plain(*args, **kw)
    assert float(nk) == float(npl) and float(llk) == float(llp)


@pytest.mark.parametrize("mode", ["loglik", "moments", "segment", "density"])
def test_pf_kernel_seeded_calls_bitwise_equal(cuda_device, mode):
    """Two seeded calls of each of kernel A's modes give the same bits,
    resampling included (Philox noise, threshold 0.1; every grid-wide sum
    in one fixed order)."""
    N, T = 100_000, 200
    pf = _model(N, cuda_device)
    if mode == "density":
        pf = pf.replace(measurement_density=llpt.TupleProduct(
            [llpt.StudentT(4.0, 0.0, 0.35), llpt.Laplace(0.0, 0.25)]))
    _, u, y = _data(T)
    args = pf_scan.scan_inputs(pf, u.float().to(cuda_device),
                               y.float().to(cuda_device))
    kw = dict(N=N, thresh=0.1, seed=5, dens=pf_scan.scan_density(
        pf, cuda_device))
    if mode == "moments":
        kw["moments"] = 2
    if mode == "segment":
        g = torch.Generator().manual_seed(2)
        kw.update(segment=True, x0=torch.randn(N, 2, generator=g).to(
            cuda_device), w0=torch.randn(N, generator=g).to(cuda_device))
    one, two = (pf_scan.pf_scan(*args, **kw) for _ in range(2))
    assert mode == "segment" or float(one["nres"]) >= 1
    assert one.keys() == two.keys()
    for name in one:
        assert torch.equal(one[name], two[name]), name


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


def _bank_case(Bk, T, nx, nu, shared, device):
    """Kernel F's inputs for a bank of Bk members: the 2-state model (or
    a random 4-state one with ny = 4), N(0, 1) outputs and 0.3 N(0, 1)
    inputs (one sequence for the bank where ``shared``)."""
    if nx == 2:
        kf = convert.kalman_filter_from_numpy(
            A, B if nu else None, C, 0, R1, R2, dtype=torch.float32,
            device=device)
    else:
        rng = np.random.default_rng(nx)
        G1, G2 = rng.normal(size=(nx, nx)), rng.normal(size=(nx, nx))
        kf = convert.kalman_filter_from_numpy(
            0.9 * np.linalg.qr(rng.normal(size=(nx, nx)))[0],
            0.2 * rng.normal(size=(nx, nu)), rng.normal(size=(nx, nx)),
            0.05 * rng.normal(size=(nx, nu)),
            0.01 * (G1 @ G1.T + nx * np.eye(nx)),
            0.1 * (G2 @ G2.T + nx * np.eye(nx)), dtype=torch.float32,
            device=device)
    ny = kf.ny
    g = torch.Generator().manual_seed(Bk + T)
    ys = torch.randn(Bk, T, ny, generator=g).to(device)
    us = (0.3 * torch.randn(T, nu, generator=g).to(device)
          [None].expand(Bk, T, nu) if shared
          else 0.3 * torch.randn(Bk, T, nu, generator=g).to(device))
    _, Sch, K, _, Am, Bm, Cm, Dm = tbank._shared_recursion(
        kf, T, torch.float32, device)
    scal, _ = bank_scan.bank_scalars(Sch, K, Am, Bm, Cm, Dm, nu)
    return scal, ys, us, kf.d0.mean.float().contiguous(), nx, ny, nu


@pytest.mark.parametrize("Bk,T,nx,nu,shared", [
    (1024, 200, 2, 1, False), (8192, 2000, 2, 1, False),
    (256, 10_000, 2, 1, False), (37, 70, 2, 1, True), (300, 65, 2, 0, False),
    (2049, 65, 2, 0, False), (1023, 33, 2, 1, False), (4097, 65, 2, 1, False),
    (5, 1, 2, 1, False), (37, 1, 4, 4, False), (37, 33, 4, 4, False),
    (513, 2001, 2, 1, False), (37, 33, 4, 2, False)])
def test_bank_kernel_matches_twin(cuda_device, Bk, T, nx, nu, shared):
    """Kernel F against its plain twin on the card, rtol 2e-5, atol 1e-4
    (f32; the kernel contracts multiply-adds): phase 6's bank, a sweep
    (B = 8192, T = 2000), a long record (B = 256, T = 1e4, 45 segments),
    a shared input, no input, banks that are no multiple of a block's
    members (2049 at 8, 1023 at 4, 4097 at 16: two a warp, the last warp
    with one), T = 1, nx = ny = nu = 4, and odd T, where the members'
    rows start 0-3 floats past a 16-byte boundary (u at nu = 1, 2)."""
    args = _bank_case(Bk, T, nx, nu, shared, cuda_device)
    before = bank_scan.BANK_LOGLIK.launches
    got = bank_scan.bank_loglik_scan(*args)
    assert bank_scan.BANK_LOGLIK.launches == before + 1
    want = bank_scan.bank_loglik_scan_plain(*args)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=1e-4)


def test_bank_kernel_nan_stays_in_its_member(cuda_device):
    """A NaN in one member's y makes that member's ll NaN on the card and
    leaves the other 1023 bit for bit as they were."""
    scal, ys, us, x0, nx, ny, nu = _bank_case(1024, 200, 2, 1, False,
                                              cuda_device)
    before = bank_scan.BANK_LOGLIK.launches
    ll0 = bank_scan.bank_loglik_scan(scal, ys, us, x0, nx, ny, nu)
    ys = ys.clone()
    ys[17, 123, 0] = float("nan")
    ll1 = bank_scan.bank_loglik_scan(scal, ys, us, x0, nx, ny, nu)
    assert bank_scan.BANK_LOGLIK.launches == before + 2
    keep = torch.arange(1024, device=cuda_device) != 17
    assert torch.isnan(ll1[17]) and torch.isfinite(ll0).all()
    assert torch.equal(ll1[keep], ll0[keep])


def test_bank_kernel_member_independent_of_bank(cuda_device):
    """A member's ll on the card is the same, bit for bit, in banks of 512,
    513 and 4096 members (4 warps a block and one member a warp, or 16
    and two), and from views whose data starts off a 16-byte boundary
    (the wrapper copies them), at T = 2001."""
    scal, ys, us, x0, nx, ny, nu = _bank_case(4096, 2001, 2, 1, False,
                                              cuda_device)
    before = bank_scan.BANK_LOGLIK.launches
    whole = bank_scan.bank_loglik_scan(scal, ys, us, x0, nx, ny, nu)
    assert torch.isfinite(whole).all()
    for Bk in (512, 513):
        part = bank_scan.bank_loglik_scan(scal, ys[:Bk], us[:Bk], x0, nx,
                                          ny, nu)
        assert torch.equal(part, whole[:Bk])
    assert ys[1:].data_ptr() % 16 and us[1:].data_ptr() % 16
    tail = bank_scan.bank_loglik_scan(scal, ys[1:], us[1:], x0, nx, ny, nu)
    assert torch.equal(tail, whole[1:])
    assert bank_scan.BANK_LOGLIK.launches == before + 4


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


@pytest.mark.parametrize("T", [1, 50, 130, 300, 2000])
def test_akf_kernel_matches_twin(cuda_device, T):
    """Kernel H against its twin (freeze included), ll and solution, with
    both drives, one, and none (not read); T crosses the 128-step staging
    chunks, the freeze (near step 70) and, at 2000, the tail's 256
    chunks of 8 steps; T = 50 never freezes (the prefix is all).  The
    twin runs on the CPU from T = 2000 on."""
    ekf = _cv_filters(cuda_device)
    g = torch.Generator().manual_seed(T)
    ys = torch.randn(T, 2, generator=g).to(cuda_device)
    us = 0.3 * torch.randn(T, 2, generator=g).to(cuda_device)
    A, C = ukf_scan._const_affine_kf_params(ekf, ekf.measurement_model, 4)
    cs, ds = ukf_scan.drives(ekf, us, T, cuda_device)
    gauss = ukf_scan._gaussian_inputs(ekf, cuda_device)
    for drives in ((cs, ds), (cs, None), (None, None)):
        args = (ys, *drives, *gauss, A, C, 1.01)
        twin_args = _on_cpu(args) if T >= 2000 else args
        for traj in (False, True):
            before = ukf_scan.AKF_SCAN.launches
            got = ukf_scan.akf_scan(*args, traj=traj)
            assert ukf_scan.AKF_SCAN.launches == before + 1
            _close_solution(got, ukf_scan.akf_scan_plain(*twin_args,
                                                         traj=traj))


def _on_cpu(args):
    return tuple(a.cpu() if isinstance(a, torch.Tensor) else a
                 for a in args)


def _akf_case(case, dev, drives, T):
    """Kernel H's inputs for the redesign's edge cases: ``g1``, CV with
    R1 = 1e-4 I (the steady-state G close to 1, the freeze near step
    260); ``never``, CV at T = 50 (no freeze within T); ``nx8``, an
    8-state model observed in 3 (the M = 8 instance); ``ny3``, 2 states
    observed in 3 (the generic M = 4 instance, with padding on both
    sides).  ``drives``: both, c only, or none."""
    g = torch.Generator().manual_seed(T + len(case))
    if case in ("nx8", "ny3"):
        nx, ny = (8, 3) if case == "nx8" else (2, 3)
        A = 0.95 * torch.eye(nx) + 0.05 * torch.roll(torch.eye(nx), 1, 0)
        C = 0.5 * torch.randn(ny, nx, generator=g)
        R1_, R2_, P0 = (0.01 * torch.eye(nx), 0.5 * torch.eye(ny),
                        torch.eye(nx))
    else:
        nx, ny = 4, 2
        A, C = torch.tensor(CV_A, dtype=torch.float32), torch.tensor(
            CV_C, dtype=torch.float32)
        R1_ = (1e-4 if case == "g1" else 0.1) * torch.eye(4)
        R2_, P0 = torch.eye(2), 0.5 * torch.eye(4)
    ys = torch.randn(T, ny, generator=g)
    cs = 0.3 * torch.randn(T, nx, generator=g) if drives != "none" else None
    ds = 0.2 * torch.randn(T, ny, generator=g) if drives == "both" else None
    cpu = (ys, cs, ds, torch.zeros(nx), P0, R1_, R2_, A, C, 1.0)
    return tuple(a.to(dev) if isinstance(a, torch.Tensor) else a
                 for a in cpu), cpu


@pytest.mark.parametrize("drives", ["both", "c", "none"])
@pytest.mark.parametrize("case, T", [("g1", 5000), ("never", 50),
                                     ("nx8", 2000), ("ny3", 300)])
def test_akf_kernel_edge_cases_match_twin(cuda_device, case, T, drives):
    """Kernel H's prefix and tail against the float32 twin on the CPU:
    the ll within 1e-5 relative and R, Rt, S, K within the usual bounds
    in every case.  x(t|t-1), x(t|t) and e within the usual bounds too,
    except at G close to 1 with drives, where the state walks to |x| ~ 13
    and the serial float32 twin itself is 2-3e-5 from float64 there: the
    kernel's reassociated tail must then be no farther from the float64
    recursion than twice the twin's distance (plus 1e-6)."""
    args, cpu = _akf_case(case, cuda_device, drives, T)
    for traj in (False, True):
        got = ukf_scan.akf_scan(*args, traj=traj)
        want = ukf_scan.akf_scan_plain(*cpu, traj=traj)
        if not (traj and case == "g1" and drives != "none"):
            _close_solution(got, want)
            continue
        _close_solution((got[0], got[1][1:2] + got[1][3:4] + got[1][5:]),
                        (want[0], want[1][1:2] + want[1][3:4]
                         + want[1][5:]))
        truth = ukf_scan.akf_scan_plain(
            *(a.double() if isinstance(a, torch.Tensor) else a
              for a in cpu), traj=True)[1]
        for k in (0, 2, 4):   # x, xt, e
            err_k = float((got[1][k].cpu().double() - truth[k]).abs().max())
            err_t = float((want[1][k].double() - truth[k]).abs().max())
            assert err_k <= 2 * err_t + 1e-6, (ukf_scan._FIELDS[k], err_k,
                                               err_t)


def test_akf_kernel_two_calls_bitwise_and_reports_freeze(cuda_device):
    """Two calls of kernel H give equal bits (the ll summed in a fixed
    tree order), the solution too; its stats report the freeze step
    within 2 of the twin's (float32 rounding moves the freeze test's
    crossing), and the prefix and the tail in cycles; at T = 50 nothing
    freezes."""
    for case, T in (("g1", 5000), ("never", 50)):
        args, cpu = _akf_case(case, cuda_device, "both", T)
        a = ukf_scan.akf_scan(*args, traj=True)
        b = ukf_scan.akf_scan(*args, traj=True)
        assert torch.equal(a[0], b[0])
        assert all(torch.equal(x, y) for x, y in zip(a[1], b[1]))
        stats = torch.zeros(6, dtype=torch.int64, device=cuda_device)
        ll = ukf_scan.akf_scan(*args, stats=stats)[0]
        assert torch.equal(ll, a[0])
        tf, pre, tail = stats.tolist()[:3]
        want = ukf_scan.akf_freeze_step(*cpu[4:], T)
        assert abs(tf - want) <= 2 and pre > 0 and tail >= 0
        assert (tf == T) == (case == "never")

def _nonlinear_input_ekf(dev):
    """``A x + B u + 0.01 sin x``: kernel I with inputs staged."""
    A, Bm, C = (_t32(M, dev) for M in (CV_A, CV_B, CV_C))
    return llpt.make_ekf(
        lambda x, u, p, t: A @ x + Bm @ u + 0.01 * torch.sin(x),
        lambda x, u, p, t: C @ x, 0.1 * torch.eye(4, device=dev),
        torch.eye(2, device=dev), nu=2, ny=2)


@pytest.mark.parametrize("T", [0, 1, 127, 128, 129, 300, 5000])
@pytest.mark.parametrize("case", ["forward", "user_jac", "input"])
def test_ekf_kernel_matches_twin(cuda_device, case, T):
    """Kernel I against its twin, ll and solution, with the Jacobians
    differentiated at code generation, the user's, and with inputs; T
    crosses the staging and ring chunks (128 steps, 64 with the
    trajectory)."""
    ekf = (_nonlinear_input_ekf(cuda_device) if case == "input" else
           _cv_filters(cuda_device, nonlinear=True,
                       user_jac=case == "user_jac"))
    g = torch.Generator().manual_seed(T)
    ys = torch.randn(T, 2, generator=g).to(cuda_device)
    us = (0.3 * torch.randn(T, 2, generator=g).to(cuda_device)
          if case == "input" else None)
    for traj in (False, True):
        before = ukf_scan.EKF_SCAN.launches
        got = ukf_scan.ekf_scan(ekf, ys, us, traj=traj)
        assert ukf_scan.EKF_SCAN.launches == before + 1
        if T == 0:  # the twin stacks no steps: ll 0 and empty fields
            assert float(got[0]) == 0.0
            assert got[1] is None or all(o.shape[0] == 0 for o in got[1])
            continue
        _close_solution(got, ukf_scan.ekf_scan_plain(ekf, ys, us, traj=traj))


def _sized_ekf(nx, ny, dev):
    """A nonlinear EKF of any size: ``A x + 0.05 tanh x``, ``C x + 0.1
    sin(C x)``."""
    g = torch.Generator().manual_seed(10 * nx + ny)
    A = (0.9 * torch.eye(nx) + 0.05 * torch.randn(nx, nx, generator=g)).to(
        dev)
    C = torch.randn(ny, nx, generator=g).to(dev)
    return llpt.make_ekf(
        lambda x, u, p, t: A @ x + 0.05 * torch.tanh(x),
        lambda x, u, p, t: C @ x + 0.1 * torch.sin(C @ x),
        0.1 * torch.eye(nx, device=dev), torch.eye(ny, device=dev), ny=ny,
        nu=0)


@pytest.mark.parametrize("nx,ny", [(1, 1), (2, 3), (8, 8)])
def test_ekf_kernel_other_sizes(cuda_device, nx, ny):
    """Kernel I's ring and chunk length follow the sizes (at nx = ny = 8
    the trajectory ring holds 16 steps a chunk): ll and solution against
    the twin at T = 300."""
    ekf = _sized_ekf(nx, ny, cuda_device)
    ys = torch.randn(300, ny, generator=torch.Generator().manual_seed(nx)
                     ).to(cuda_device)
    for traj in (False, True):
        _close_solution(ukf_scan.ekf_scan(ekf, ys, traj=traj),
                        ukf_scan.ekf_scan_plain(ekf, ys, traj=traj))


@pytest.mark.parametrize("rows", [300, 600])
def test_ekf_kernel_many_constants(cuda_device, rows):
    """Callbacks holding thousands of constants at nx = ny = 8 go to
    shared memory while the smallest chunk leaves room (4928 of them
    beside a trajectory ring cut to 8 steps a chunk; 9728 without the
    trajectory), else stay in device memory (9728 with the trajectory):
    ll and solution against the twin at T = 300."""
    g = torch.Generator().manual_seed(rows)
    A = 0.9 * torch.eye(8) + 0.05 * torch.randn(8, 8, generator=g)
    C, tf, tg = (torch.randn(*s, generator=g).to(cuda_device)
                 for s in ((8, 8), (rows, 8), (rows, 8)))
    A = A.to(cuda_device)
    ekf = llpt.make_ekf(
        lambda x, u, p, t: A @ x + 0.05 * torch.tanh(x) + 1e-3 * tf.mean(0),
        lambda x, u, p, t: C @ x + 0.1 * torch.sin(C @ x) + 1e-3 * tg.mean(0),
        0.1 * torch.eye(8, device=cuda_device),
        torch.eye(8, device=cuda_device), ny=8, nu=0)
    comp = ukf_scan._ekf_programs(ekf, 0, cuda_device)
    assert sum(p.n_consts for _, p in comp.progs) == 128 + 16 * rows
    ys = torch.randn(300, 8, generator=g).to(cuda_device)
    for traj in (False, True):
        _close_solution(ukf_scan.ekf_scan(ekf, ys, traj=traj),
                        ukf_scan.ekf_scan_plain(ekf, ys, traj=traj))


def test_ekf_step_loop_reads_no_device_memory(cuda_device):
    """The compiled step loop of kernel I loads nothing from device memory:
    the callbacks' constants sit in registers (``cuobjdump -sass`` through
    ``kernels/sass.py``)."""
    from lowlevelparticlefilters_jl_tpu_torch.kernels import sass

    for user_jac in (False, True):
        ekf = _cv_filters(cuda_device, nonlinear=True, user_jac=user_jac)
        lib = ukf_scan._ekf_programs(ekf, 0, cuda_device).library()
        text = sass.disassemble(lib._name)
        for traj in (False, True):
            loop = sass.step_loop(text, "ekf_scan_kernel", traj)
            assert loop.get("LDG", 0) == 0, loop


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


def _nx8_ukf(dev):
    """8 states, 17 sigma points: x' = A8 x + 0.01 sin x, y = x[:4]."""
    A8 = 0.95 * torch.eye(8, device=dev) + 0.05 * torch.roll(
        torch.eye(8, device=dev), 1, 0)
    return llpt.make_ukf(lambda x, u, p, t: A8 @ x + 0.01 * torch.sin(x),
                         lambda x, u, p, t: x[:4],
                         0.01 * torch.eye(8, device=dev),
                         0.1 * torch.eye(4, device=dev), ny=4, nu=0)


@pytest.mark.parametrize("layout", ["default", "thread", "warp"])
def test_ukf_kernel_nx8_matches_twin(cuda_device, layout, monkeypatch):
    """Kernel G at nx = 8 (17 sigma points) against its twin, with and
    without the trajectory, in its default layout and forced into each
    (``ukf_scan.ukf_layout``)."""
    if layout != "default":
        monkeypatch.setattr(ukf_scan, "UKF_THREAD_MAX_NX",
                            8 if layout == "thread" else 0)
    ukf = _nx8_ukf(cuda_device)
    assert ukf_scan._ukf_programs(ukf, 0, cuda_device).layout == (
        ukf_scan.ukf_layout(8) if layout == "default" else layout)
    ys = torch.randn(300, 4, generator=torch.Generator().manual_seed(8)
                     ).to(cuda_device)
    for traj in (False, True):
        _close_solution(ukf_scan.ukf_scan(ukf, ys, traj=traj),
                        ukf_scan.ukf_scan_plain(ukf, ys, traj=traj))


def test_ukf_step_loop_reads_no_device_memory(cuda_device):
    """Kernel G's compiled step loop (quadtank, one thread for the five
    sigma points) loads nothing from device memory and shuffles nothing on
    its hot path."""
    from lowlevelparticlefilters_jl_tpu_torch.kernels import sass

    lib = ukf_scan._ukf_programs(_quadtank(cuda_device), 0,
                                 cuda_device).library()
    text = sass.disassemble(lib._name)
    for traj in (False, True):
        loop = sass.step_loop(text, "ukf_scan_kernel", traj)
        assert loop.get("LDG", 0) == 0 and loop.get("SHFL", 0) == 0, loop


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
                                      (3, 6, 4099, 33), (8, 4, 300, 16),
                                      (2, 4, 65536, 24)])
def test_ffbs_kernel_matches_twin(cuda_device, nx, T, N, M):
    """Kernel J against its twin on the same inputs: the MAP columns
    (no noise) exactly, and with the same uniforms at most 0.1 % of the
    (t, m) draws apart (expected none: kernel and twin round every
    operation alike, and expf is what torch.exp calls); never a -inf
    column; every row a forward particle.  N = 4099 and 65536 sweep
    several chunks of 1024 columns (the chunk search, the chosen chunk
    scored again, the row read from L2), the others one (staged whole,
    the row read from shared memory)."""
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


def test_ffbs_kernel_edge_rows_and_block_shapes(cuda_device):
    """Kernel J's draw on the rows its rule singles out, against the
    twin, bitwise: a step with no finite score (column 0), a step with
    NaN scores (never drawn), a step whose weights fall by 200 across the
    chunks; at M = 21 (a trajectory a block) and M = 141 (two a block on
    132 SMs, the last block's second warp idle)."""
    for N, M in ((1000, 21), (5000, 21), (1000, 141)):
        args = list(_ffbs_inputs(cuda_device, 5, N, M, 2, seed=N))
        wfc = args[1].clone()
        wfc[0] = float("-inf")
        wfc[1, ::2] = float("nan")
        wfc[2] = torch.linspace(-200.0, 0.0, N, device=cuda_device)
        args[1] = wfc
        for noise_on in (False, True):
            ref, ridx = ffbs.ffbs_backward_plain(*args, 5, noise=noise_on,
                                                 return_indices=True)
            assert bool((ridx[0] == 0).all())
            assert not bool((ridx[1] % 2 == 0).any())
            out, idx = ffbs.ffbs_backward_scan(*args, 5, noise=noise_on,
                                               return_indices=True)
            assert torch.equal(idx, ridx) and torch.equal(out, ref)


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


_A4 = 0.9 * np.eye(4) + 0.05 * np.roll(np.eye(4), 1, 0)


def _prop_pf(case, dev, cov=None):
    """Kernel D's filters: the benchmark's affine dynamics (nu = 1), or
    ``A4 x + 0.01 sin x`` (nu = 0); ``cov`` replaces the process noise
    covariance."""
    if case == "nonlinear":
        At = torch.tensor(_A4, dtype=torch.float32, device=dev)
        f = lambda x, u, p, t: At @ x + 0.01 * torch.sin(x)  # noqa: E731
        nx, mean = 4, 0.1 * np.ones(4)
    else:
        f, _ = convert.linear_callbacks(A, B, C, device=dev)
        nx, mean = 2, [0.05, -0.02]
    cov = 0.01 * np.eye(nx) + 0.002 if cov is None else cov
    return convert.particle_filter_from_numpy(
        50_000, f, lambda x, u, p, t: x[:2], cov, R2, np.eye(nx),
        R1_mean=mean, noise_backend="kernel", resample_threshold=0.0,
        device=dev)


@pytest.mark.parametrize("singular", [False, True])
@pytest.mark.parametrize("case", ["affine", "nonlinear"])
def test_propagate_forms_match_twin(cuda_device, case, singular):
    """Kernel D's compiled form (the dynamics in the kernel) and its xn
    form (``f(x)`` from PyTorch: a ``p`` other than the filter's own)
    through ``pf.predict``, each against the twin on the same CUDA
    tensors and seed: within 1e-5 absolute (the same normals; fused
    multiply-adds against PyTorch's separate products and sums); a
    covariance with a zero pivot gives NaN in the same places in all
    three."""
    nx = 4 if case == "nonlinear" else 2
    cov = np.diag([0.0] + [0.01] * (nx - 1)) if singular else None
    pf = _prop_pf(case, cuda_device, cov)
    x = torch.randn(pf.N, nx, generator=torch.Generator().manual_seed(0)
                    ).to(cuda_device)
    u = torch.full((1 if nx == 2 else 0,), 0.3, device=cuda_device)
    st = pf.init(torch.Generator(device=cuda_device).manual_seed(0)
                 ).replace(x=x, t=7)
    d1 = pf.dynamics_density
    twin = noise.propagate_plain(
        pf.dynamics, x, u, None, 7.0, d1.cov, d1.mean,
        llpt.routing.seed_tensor(torch.Generator(device=cuda_device)
                                 .manual_seed(1), cuda_device), 7)
    for p, route in ((None, "cuda_propagate_compiled"),
                     ((), "cuda_propagate")):
        before = noise.ADD_GAUSSIAN_NOISE.launches
        got = pf.predict(st.replace(generator=torch.Generator(
            device=cuda_device).manual_seed(1)), u, p).x
        assert llpt.last_route("predict") == route
        assert noise.ADD_GAUSSIAN_NOISE.launches == before + 1
        assert torch.equal(got.isnan(), twin.isnan())
        assert bool(got.isnan().any()) == singular
        torch.testing.assert_close(got.nan_to_num(), twin.nan_to_num(),
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("nx", [2, 4])
def test_propagate_draws_equal_kernel_c(cuda_device, nx):
    """Kernel D's normals are bitwise kernel C's at the same Philox
    counters (row i, step, block, TAG_PROPAGATE), as before the redesign:
    with f(x) = 0, R1 = I and a zero mean both forms return them
    exactly."""
    N, step = 100_003, 5
    seed = torch.tensor(987654321, device=cuda_device)
    zc = noise.normal(987654321, (N, 4), tag=noise.TAG_PROPAGATE, step=step,
                      device=cuda_device)[:, :nx]
    eye, zero = torch.eye(nx, device=cuda_device), torch.zeros(
        nx, device=cuda_device)
    xn = torch.zeros(N, nx, device=cuda_device)
    assert torch.equal(noise.add_gaussian_noise(xn, eye, zero, seed, step),
                       zc)
    pf = convert.particle_filter_from_numpy(
        N, lambda x, u, p, t: 0.0 * x, lambda x, u, p, t: x, np.eye(nx),
        np.eye(nx), np.eye(nx), noise_backend="kernel", device=cuda_device)
    comp = noise.propagate_program(pf, 0, cuda_device)
    u0 = torch.zeros(0, device=cuda_device)
    assert torch.equal(noise.propagate(pf, comp, xn, u0, 0.0, seed, step),
                       zc)


def test_propagate_step_syncs_nothing(cuda_device):
    """A predict step's kernel D call (the route, the seed draw, the
    launch) makes no host synchronization once the filter's program is
    built; the Neff decision before it is the filter's own."""
    pf = _prop_pf("affine", cuda_device)
    x = torch.randn(pf.N, 2, device=cuda_device)
    u = torch.full((1,), 0.3, device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    llpt.routing.route_pf_propagate(pf, x, u, None, 0.0, g, 0)  # builds
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for step in range(3):
            out = llpt.routing.route_pf_propagate(pf, x, u, None, 1.0, g,
                                                  step)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert llpt.last_route("predict") == "cuda_propagate_compiled"
    assert out.shape == x.shape and bool(torch.isfinite(out).all())


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
    """Kernel E's index and gather against its twin: j and the rows
    bitwise, f32 and f64 rows, from float64 weights and r = 0.37."""
    g = torch.Generator().manual_seed(nx)
    N = 100_000
    we = torch.rand(N, generator=g, dtype=torch.float64)
    if profile == "skewed":
        we = we ** 20
    elif profile == "single":
        we = torch.zeros(N, dtype=torch.float64)
        we[12345] = 1.0
    we, r = we / we.sum(), torch.tensor(0.37, dtype=torch.float64)
    for dtype in (torch.float32, torch.float64):
        x = torch.randn(N, nx, generator=g, dtype=dtype)
        out_p, j_p = resample_v2.systematic_resample_plain(x, we, r)
        before = resample_v2.SYSTEMATIC_RESAMPLE.launches
        out, j = resample_v2.systematic_resample(
            x.to(cuda_device), we.to(cuda_device), r.to(cuda_device))
        assert resample_v2.SYSTEMATIC_RESAMPLE.launches == before + 1
        assert j.dtype == torch.int32
        assert torch.equal(j.cpu(), j_p) and torch.equal(out.cpu(), out_p)
    if profile == "single":
        assert bool((j == 12345).all())


def _weights_of(profile, N, g, dtype):
    we = torch.rand(N, generator=g, dtype=torch.float64)
    if profile == "skewed":
        we = we ** 20
    elif profile == "single":
        we = torch.zeros(N, dtype=torch.float64)
        we[N // 3] = 1.0
    return (we / we.sum()).to(dtype)


@pytest.mark.parametrize("N", [1, 1000, 8191, 100_000, 100_003])
@pytest.mark.parametrize("profile", ["random", "skewed", "single"])
def test_systematic_resample_bitwise(cuda_device, N, profile):
    """Kernel E from the weights to the cloud against its twin, on the
    card and on the CPU: K, j and the rows bitwise, f32 and f64 weights and
    rows, nx 2 and 8; N = 1, not a multiple of a tile (8192) or of a run
    (32); one launch a call."""
    g = torch.Generator().manual_seed(N)
    for wdt in (torch.float32, torch.float64):
        we = _weights_of(profile, N, g, wdt)
        r = torch.rand((), generator=g, dtype=wdt)
        K_p = resample_v2.systematic_slots_plain(we, r, N)
        assert torch.equal(resample_v2.systematic_slots_plain(
            we.to(cuda_device), r.to(cuda_device), N).cpu(), K_p)
        for nx, xdt in ((2, wdt), (8, torch.float32), (2, torch.float64)):
            x = torch.randn(N, nx, generator=g, dtype=xdt)
            out_p, j_p = resample_v2.systematic_resample_plain(x, we, r)
            before = resample_v2.SYSTEMATIC_RESAMPLE.launches
            out, j = resample_v2.systematic_resample(
                x.to(cuda_device), we.to(cuda_device), r.to(cuda_device))
            assert resample_v2.SYSTEMATIC_RESAMPLE.launches == before + 1
            assert j.dtype == torch.int32
            assert torch.equal(j.cpu(), j_p) and torch.equal(out.cpu(), out_p)
        if profile == "single":
            assert bool((j == N // 3).all())


@pytest.mark.parametrize("N,M", [(1, 1), (100_000, 100_000),
                                 (100_003, 4097), (8193, 20_000)])
def test_systematic_slots_bitwise(cuda_device, N, M):
    """E's slot stage against its twin bitwise for M slots, and
    ``_systematic_slots`` on a card's 1-D weights takes it (kernel B's
    route): one launch."""
    g = torch.Generator().manual_seed(M)
    for wdt in (torch.float32, torch.float64):
        we = _weights_of("skewed", N, g, wdt)
        r = torch.rand((), generator=g, dtype=wdt)
        want = resample_v2.systematic_slots_plain(we, r, M)
        before = resample_v2.SYSTEMATIC_SLOTS.launches
        got = trs._systematic_slots(we.to(cuda_device), r.to(cuda_device), M)
        assert resample_v2.SYSTEMATIC_SLOTS.launches == before + 1
        assert got.dtype == torch.int32 and torch.equal(got.cpu(), want)


def test_exact_resample_syncs_nothing(cuda_device):
    """An exact resample (the offset drawn on the card, kernel E) and the
    default one (E's slot stage, kernel B) make no host synchronization,
    and two seeded calls give the same bits."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(100_000, 2, generator=g).to(cuda_device)
    we = _weights_of("random", 100_000, g, torch.float32).to(cuda_device)
    gen = torch.Generator(device=cuda_device)
    resample_v2.fused_systematic_gather(x, we, gen)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        a = resample_v2.fused_systematic_gather(x, we, gen.manual_seed(1))
        b = resample_v2.fused_systematic_gather(x, we, gen.manual_seed(1))
        c = trs.resample_systematic_gather(x, we, gen.manual_seed(1))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert torch.equal(a[0], c)


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
    e0 = resample_v2.SYSTEMATIC_RESAMPLE.launches
    for exact in (True, False):
        sols.append(pf.replace(exact_resample=exact).forward_trajectory(
            uc, yc, generator=g.manual_seed(1)))
    resamples = int((1.0 / (sols[0].we ** 2).sum(-1) < 0.1 * pf.N).sum())
    assert resamples >= 1
    assert resample_v2.SYSTEMATIC_RESAMPLE.launches == e0 + resamples
    for f in ("x", "w", "we", "ll"):
        assert torch.equal(getattr(sols[0], f), getattr(sols[1], f)), f
    b0 = resample_route.SYSTEMATIC_GATHER.launches
    apf = llpt.AuxiliaryParticleFilter(pf=pf)
    ll = apf.loglik(uc, yc, generator=g.manual_seed(2))
    assert resample_route.SYSTEMATIC_GATHER.launches == b0 + 59
    ll_kf = float(llpt.loglik(kf, u, y))
    assert abs(float(ll) - ll_kf) < 0.05 * abs(ll_kf)


@pytest.mark.parametrize("nx", [1, 2, 3, 4, 5, 6, 7, 8])
def test_assoc_scan_every_nx_and_mode(cuda_device, nx):
    """Kernel K at every nx, ragged T, in its three modes (filter, smooth,
    whole elements) against the twin, rtol 2e-4, atol 2e-5 (the whole
    elements 2e-5 of their scale); one launch each; two calls bitwise
    equal."""
    T = 5003
    for kind in (0, 1):
        el = _elements(kind, T, nx, seed=nx * 31 + kind)
        run = assoc_scan.filter_scan if kind == 0 else assoc_scan.smooth_scan
        ref = run(*el)
        elc = [e.to(cuda_device) for e in el]
        before = assoc_scan.ASSOC_SCAN.launches
        out = run(*elc)
        assert assoc_scan.ASSOC_SCAN.launches == before + 1
        again = run(*elc)
        for o, a, r in zip(out, again, ref):
            assert torch.equal(o, a)
            torch.testing.assert_close(o.cpu(), r, rtol=2e-4, atol=2e-5)
    el = _elements(0, T, nx, seed=nx * 31 + 2)
    want = assoc_scan.filter_scan_full_plain(*el)
    n0 = assoc_scan.ASSOC_SCAN_FULL.launches
    got = assoc_scan.filter_scan_full(*(e.to(cuda_device) for e in el))
    assert assoc_scan.ASSOC_SCAN_FULL.launches == n0 + 1
    for a, b in zip(got, want):
        torch.testing.assert_close(a.cpu(), b, rtol=2e-4,
                                   atol=2e-5 * (1 + float(b.abs().max())))


@pytest.mark.parametrize("kind", [0, 1, 2])
def test_assoc_scan_deterministic(cuda_device, kind):
    """Kernel K gives the same bits call after call at T = 1e5 (no atomics,
    a fixed association), in each mode."""
    T, nx = 100_000, 2
    el = _elements(min(kind, 1) if kind < 2 else 0, T, nx, seed=kind)
    x = torch.cat([e.reshape(T, -1) for e in el], -1).to(cuda_device)
    if kind == 2:
        call = lambda: assoc_scan.full_scan(x, nx)  # noqa: E731
    else:
        call = lambda: assoc_scan.plane_scan(x, nx, kind)  # noqa: E731
    first = call()
    assert bool(torch.isfinite(first).all())
    for _ in range(5):
        assert torch.equal(call(), first)


# ---- K's whole-element mode, grad-aware routing, the sharded verbs ---------


@pytest.mark.parametrize("nx,T", [(1, 1), (2, 17), (3, 300), (8, 5000),
                                  (2, 100_000)])
def test_assoc_scan_full_matches_twin(cuda_device, nx, T):
    """K's whole-element mode against its twin on generic elements (no
    prior element, so A, eta and J stay nontrivial): every stack within
    rtol 2e-4 and an absolute 2e-5 of its scale; the input is left as it
    was; one launch."""
    from lowlevelparticlefilters_jl_tpu_torch.parallel import temporal

    g = torch.Generator().manual_seed(nx * 7 + T)
    Qm, _ = torch.linalg.qr(torch.randn(nx, nx, generator=g))
    eye = torch.eye(nx)
    rep = lambda M: M.expand(T + 1, nx, nx).to(cuda_device)  # noqa: E731
    el = temporal._filter_elements(
        rep(0.9 * Qm), torch.zeros(T + 1, nx, device=cuda_device), rep(eye),
        rep(0.01 * eye), rep(0.1 * eye),
        (0.3 * torch.randn(T + 1, nx, generator=g)).to(cuda_device),
        torch.zeros(nx, device=cuda_device), eye.to(cuda_device))
    el = tuple(e[1:].contiguous() for e in el)
    before = [e.clone() for e in el]
    n0 = assoc_scan.ASSOC_SCAN_FULL.launches
    got = assoc_scan.filter_scan_full(*el)
    want = assoc_scan.filter_scan_full_plain(*el)
    assert assoc_scan.ASSOC_SCAN_FULL.launches == n0 + 1
    assert all(torch.equal(a, b) for a, b in zip(el, before))
    for a, b in zip(got, want):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=2e-4,
                                   atol=2e-5 * (1 + float(b.abs().max())))


def test_backward_on_every_auto_route(cuda_device):
    """With a grad-requiring A (a filter field, or a tensor the callbacks
    close over) every ``auto`` route on CUDA tensors keeps off the
    forward-only kernels and ``backward`` gives a finite gradient: the KF
    below and above T_PARALLEL (H, K), its smoother, the bank (F), the
    EKF (I) and UKF (G), the PF loglik (A), the kernel-noise forward pass
    (B, D), exact resampling (E), FFBS (J) and K's whole-element mode.
    A kernel handed a tensor that requires grad raises, so a route that
    reached one would fail here."""
    from lowlevelparticlefilters_jl_tpu_torch.parallel import temporal

    dev = cuda_device
    g = torch.Generator().manual_seed(5)
    ys = (0.3 * torch.randn(300, 2, generator=g)).to(dev)
    us = torch.full((300, 1), 0.3, device=dev)

    def A32():
        return _t32(A, dev).requires_grad_()

    def kf(At):
        return convert.kalman_filter_from_numpy(
            A, B, C, 0, R1, R2, dtype=torch.float32, device=dev).replace(A=At)

    def pf(At, **kw):
        Bt, Ct = _t32(B, dev), _t32(C, dev)
        return convert.particle_filter_from_numpy(
            2000, lambda x, u, p, t: At @ x + Bt @ u,
            lambda x, u, p, t: Ct @ x, R1, R2, R1, device=dev, **kw)

    def ekf(At, ukf=False):
        make = llpt.make_ukf if ukf else llpt.make_ekf
        Ct = _t32(C, dev)
        return make(lambda x, u, p, t: At @ x + 0.01 * torch.sin(x),
                    lambda x, u, p, t: Ct @ x, _t32(R1, dev), _t32(R2, dev),
                    ny=2, nu=0)

    def elements(At, y):
        T = y.shape[0]
        rep = lambda M: M.expand(T, 2, 2)  # noqa: E731
        return temporal._filter_elements(
            rep(At), torch.zeros(T, 2, device=dev), rep(_t32(C, dev)),
            rep(_t32(R1, dev)), rep(_t32(R2, dev)), y,
            torch.zeros(2, device=dev), torch.eye(2, device=dev))

    def ffbs_out(xb, ll):
        return xb.sum() + ll

    gen = lambda: torch.Generator(device=dev).manual_seed(0)  # noqa: E731
    cases = {
        "KF T=100 (H)": lambda At: llpt.loglik(kf(At), us[:100], ys[:100]),
        "KF T=300 (K)": lambda At: llpt.loglik(kf(At), us, ys),
        "smooth (K)": lambda At: llpt.smooth(kf(At), us, ys).xT.sum(),
        "bank (F)": lambda At: llpt.kf_bank_loglik(
            kf(At), us, ys.expand(512, 300, 2).contiguous()).sum(),
        "EKF (I)": lambda At: llpt.loglik(ekf(At), None, ys[:100]),
        "UKF (G)": lambda At: llpt.loglik(ekf(At, ukf=True), None,
                                          ys[:100]),
        "PF (A)": lambda At: pf(At).loglik(us[:50], ys[:50],
                                           generator=gen()),
        "PF kernel noise (B, D)": lambda At: pf(
            At, noise_backend="kernel", resample_threshold=1.0
        ).forward_trajectory(us[:20], ys[:20], generator=gen()).ll,
        "PF exact (E)": lambda At: pf(
            At, exact_resample=True, resample_threshold=1.0
        ).forward_trajectory(us[:20], ys[:20], generator=gen()).ll,
        "FFBS (J)": lambda At: ffbs_out(*pf(At).smooth(
            us[:20], ys[:20], M=64, generator=gen())),
        "K-full": lambda At: assoc_scan.filter_scan_full(
            *elements(At, ys))[1].sum(),
    }
    for name, fn in cases.items():
        At = A32()
        fn(At).backward()
        assert At.grad is not None and bool(torch.isfinite(At.grad).all()) \
            and float(At.grad.abs().sum()) > 0, name


def test_sharded_verbs_on_card(cuda_device):
    """The time-sharded KF (K-full) and the particle-sharded fused PF
    (kernel A's segment mode) on a world of size 1 on NCCL: the KF ll
    within 1e-4 of the float64 CPU parallel route, the PF ll within 2 %
    of the KF at N = 2e4 with segments of 8 steps (at 32, a particle
    cloud this small degenerates inside a segment: 2.1 % off on the
    card)."""
    import torch.distributed as dist

    from lowlevelparticlefilters_jl_tpu_torch.parallel import sharded as sh

    kf64 = convert.kalman_filter_from_numpy(A, B, C, 0, R1, R2, device="cpu")
    u = torch.full((4096, 1), 0.3, dtype=torch.float64)
    _, u, y = llpt.simulate(kf64, u, torch.Generator().manual_seed(3))
    kf32 = convert.kalman_filter_from_numpy(A, B, C, 0, R1, R2,
                                            dtype=torch.float32,
                                            device=cuda_device)
    uc, yc = u.float().to(cuda_device), y.float().to(cuda_device)
    mesh = sh.particle_mesh(device=cuda_device)
    try:
        assert dist.get_backend(mesh.group) == "nccl" and mesh.size == 1
        n0 = assoc_scan.ASSOC_SCAN_FULL.launches
        _, _, ll = sh.time_sharded_parallel_kf(kf32, uc, yc, mesh)
        assert assoc_scan.ASSOC_SCAN_FULL.launches == n0 + 1
        ref = float(llpt.loglik(kf64, u, y, method="parallel"))
        assert abs(float(ll) - ref) < 1e-4 * abs(ref)
        f, g = convert.linear_callbacks(A, B, C, device=cuda_device)
        pf = convert.particle_filter_from_numpy(20_000, f, g, R1, R2, R1,
                                                device=cuda_device)
        s0 = pf_scan.PF_SEGMENT_SCAN.launches
        llf = sh.sharded_pf_loglik_fused(
            pf, uc[:200], yc[:200], torch.Generator(
                device=cuda_device).manual_seed(0), mesh, segment=8)
        assert pf_scan.PF_SEGMENT_SCAN.launches == s0 + 25
        ref = float(llpt.loglik(kf64, u[:200], y[:200]))
        assert abs(float(llf) - ref) < 0.02 * abs(ref)
    finally:
        dist.destroy_process_group()


# ---- parameter estimation on the card: PMMH on K, H, A; the UKF bank on F --


def _pmmh_data(T, seed):
    kf64 = convert.kalman_filter_from_numpy(A, B, C, 0, R1, R2, device="cpu")
    u = torch.full((T, 1), 0.3, dtype=torch.float64)
    _, u, y = llpt.simulate(kf64, u, torch.Generator().manual_seed(seed))
    return u, y


def _kf_scaled(s, dtype, device):
    return convert.kalman_filter_from_numpy(A, B, C, 0, R1, s * np.asarray(R2),
                                            dtype=dtype, device=device)


def _pmmh(ll, R, takes_key=False):
    g = torch.Generator().manual_seed(4)
    draw = lambda th, gen: th + 0.02 * torch.randn(  # noqa: E731
        th.shape, generator=gen, dtype=th.dtype)
    routes = []

    def tracked(th, gen=None):
        v = ll(th, gen) if takes_key else ll(th)
        routes.append(llpt.last_route())
        return v

    thetas, lls = llpt.metropolis(tracked, R, torch.tensor(
        [0.02], dtype=torch.float64), draw, generator=g,
        ll_takes_key=takes_key)
    return thetas[:, 0], lls, set(routes)


@pytest.mark.parametrize("T,route,kind", [
    (400, "cuda_temporal_parallel", "assoc_scan"),
    (200, "cuda_fused_scan", "akf_scan")])
def test_pmmh_on_the_kf_kernels(cuda_device, T, route, kind):
    """A few PMMH steps on a KF: every ll on kernel K (T >= 256) or H,
    each within 1e-4 of the f64 CPU value at its θ."""
    kern = {"assoc_scan": assoc_scan.ASSOC_SCAN,
            "akf_scan": ukf_scan.AKF_SCAN}[kind]
    u, y = _pmmh_data(T, 5)
    prior = [llpt.Normal(0.0, 1.0)]
    ll = llpt.log_likelihood_fun(
        lambda th: _kf_scaled(float(torch.exp(th[0])), torch.float32,
                              cuda_device), prior,
        u.float().to(cuda_device), y.float().to(cuda_device))
    n0 = kern.launches
    thetas, lls, routes = _pmmh(ll, 4)
    assert routes == {route} and kern.launches == n0 + 4
    for th, v in zip(thetas, lls):
        ref = float(llpt.loglik(_kf_scaled(float(torch.exp(th)),
                                           torch.float64, "cpu"), u, y,
                                method="parallel") + prior[0].logpdf(th))
        assert abs(float(v) - ref) < 1e-4 * abs(ref)


def test_pmmh_on_kernel_a(cuda_device):
    """PMMH proper on the PF (a generator to each ll): every ll on kernel
    A, each within 1 % of the f64 KF ll at its θ."""
    u, y = _pmmh_data(200, 6)
    f, g = convert.linear_callbacks(A, B, C, device=cuda_device)

    def pf_at(th):
        return convert.particle_filter_from_numpy(
            100_000, f, g, R1, float(torch.exp(th[0])) * np.asarray(R2), R1,
            device=cuda_device)

    ll = llpt.log_likelihood_fun(pf_at, [], u.float().to(cuda_device),
                                 y.float().to(cuda_device))
    n0 = pf_scan.PF_LOGLIK_SCAN.launches
    thetas, lls, routes = _pmmh(ll, 4, takes_key=True)
    assert routes == {"cuda_fused_scan"}
    assert pf_scan.PF_LOGLIK_SCAN.launches == n0 + 4
    for th, v in zip(thetas, lls):
        ref = float(llpt.loglik(_kf_scaled(float(torch.exp(th)),
                                           torch.float64, "cpu"), u, y))
        assert abs(float(v) - ref) < 0.01 * abs(ref)


def test_affine_ukf_bank_on_kernel_f(cuda_device):
    """``ukf_bank_loglik`` of an affine UKF at B = 512: one launch of F, each
    member within 1e-4 of f64 ``kf_bank_loglik`` on the equivalent KF."""
    Bk, T = 512, 100
    gen = torch.Generator().manual_seed(7)
    u = torch.full((T, 1), 0.3, dtype=torch.float64)
    ys = 0.3 * torch.randn(Bk, T, 2, generator=gen, dtype=torch.float64)
    f, g = convert.linear_callbacks(A, B, C, device=cuda_device)
    kf32 = _kf_scaled(1.0, torch.float32, cuda_device)
    ukf = llpt.make_ukf(f, g, kf32.R1, kf32.R2, nu=1, ny=2)
    n0 = bank_scan.BANK_LOGLIK.launches
    ll = llpt.ukf_bank_loglik(ukf, u.float().to(cuda_device),
                              ys.float().to(cuda_device))
    assert llpt.last_route("ukf_bank_loglik") == "cuda_bank_kernel"
    assert bank_scan.BANK_LOGLIK.launches == n0 + 1
    ref = llpt.kf_bank_loglik(_kf_scaled(1.0, torch.float64, "cpu"), u, ys)
    assert float(((ll.double().cpu() - ref).abs() / ref.abs()).max()) < 1e-4


@pytest.mark.parametrize("per_particle", [False, True],
                         ids=["single_riccati", "per_particle"])
def test_rbpf_resamples_through_e_and_b_on_card(cuda_device, monkeypatch,
                                                per_particle):
    """The RBPF's systematic resample of ``[xn, xl, (R)]`` is one launch
    of kernel E's slot stage and one of kernel B a resample (threshold 1:
    every step), and the run matches the CPU run of the same filter in
    float64 on the same draws (replayed through ``filters/rbpf.py::
    _sample``), where both kernels' twins run; rtol 1e-9."""
    from lowlevelparticlefilters_jl_tpu_torch.filters import rbpf as frb

    N, T = 2048, 20

    def rbpf(dev):
        kf = convert.kalman_filter_from_numpy(
            [[0.95]], np.zeros((1, 0)), [[1.0]], 0, [[0.01]], [[0.1]],
            [1.0], [[1.0]], device=dev)
        return convert.rbpf_from_numpy(
            N, kf, lambda xn, u, p, t: 0.9 * xn + 0.1 * torch.sin(xn),
            lambda xn, u, p, t: 0.5 * torch.sin(xn), [[0.1]], [[0.01]],
            [[0.01]], d0n_mean=[1.0], An=[[0.5]], nu=0,
            resample_threshold=1.0, single_riccati=not per_particle,
            dtype=torch.float64, device=dev)

    rng = np.random.default_rng(3)
    y = torch.tensor(1.0 + 0.3 * rng.normal(size=(T, 1)))
    draws = [1.0 + 0.1 * rng.normal(size=(N, 1))]
    for _ in range(T):
        draws += [rng.uniform(), 0.1 * rng.normal(size=(N, 1))]

    def run(dev):
        q = list(draws)
        monkeypatch.setattr(frb, "_sample", lambda *a, **k: torch.tensor(
            q.pop(0), dtype=torch.float64, device=dev))
        return llpt.forward_trajectory(rbpf(dev), torch.zeros(T, 0,
                                                               device=dev),
                                       y.to(dev), generator=None)

    E, B_ = resample_v2.SYSTEMATIC_SLOTS, resample_route.SYSTEMATIC_GATHER
    e0, b0 = E.launches, B_.launches
    got = run(cuda_device)
    assert E.launches - e0 == T and B_.launches - b0 == T
    want = run("cpu")
    for f in ("x", "we", "ll"):
        np.testing.assert_allclose(getattr(got, f).cpu().numpy(),
                                   getattr(want, f).numpy(), rtol=1e-9,
                                   atol=1e-12, err_msg=f)
