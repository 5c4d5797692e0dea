"""The whole bootstrap-PF log-likelihood in one launch, kernel A
(counterpart of ``ops/pallas/pf_scan.py``, its ``pf_loglik_fused``
entry).

The JAX kernel traces the user callbacks into its body and, when a
jaxpr walk proves them affine in x, evaluates them from per-step
matrices.  A compiled kernel cannot take a callback, so here admission
IS that affine case: the callbacks lowered by ``callback_codegen`` must
pass its static walk (``affine_in``, the jaxpr walk's counterpart; one
verdict per filter), and concrete probes at every step
(``torch.func.jacfwd`` at x = 0 and at two states four standard
deviations out, as ``ukf_scan.py::_const_affine_kf_params`` probes in
the JAX package) confirm it.  The per-step coefficients
``[T, nx·nx + nx + ny·nx + ny]`` = (M_t, c_t, H_t, d_t) are built as
``pf_scan.py:627-642`` builds them.

``noise="none"`` is the JAX kernel's deterministic mode: no process
noise, resampling offset r = 0.5.  ``noise="philox"`` draws the initial
cloud, the process noise and r from Philox keyed by ``seed``.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..filters.particle import ParticleFilter
from ..ops.linalg import chol_lower, tri_solve
from ..ops.mvnormal import MvNormal
from ..trajectory import _as_u_seq
from ._lib import (KernelInfo, check, library, require_cuda_f32,
                   stream_ptr)
from .noise import (TAG_INIT, TAG_PROPAGATE, normals_plain,
                    resample_offset_plain)
from .resample_route import slot_sources
from .ukf_scan import callbacks_affine

PF_LOGLIK_SCAN = KernelInfo(
    "pf_loglik_scan", "lowlevelparticlefilters_jl_tpu_torch/csrc/pf_scan.cu",
    "lowlevelparticlefilters_jl_tpu/ops/pallas/pf_scan.py:747")

_LOG2PI = 1.8378770664093453
NOISE_MODES = ("philox", "none")
MAX_DIM = 8


def _scalars(L2inv: torch.Tensor, N: int, thresh: float):
    """f32 constants shared by the kernel and its plain twin: the
    Gaussian log-density constant, f32(thresh·N) and -log f32(N)."""
    ny = L2inv.shape[0]
    cst = (torch.tensor(-0.5 * (ny * _LOG2PI), dtype=torch.float32)
           + torch.log(torch.abs(torch.diagonal(L2inv.detach().cpu()))).sum())
    thr_n = torch.tensor(thresh * N, dtype=torch.float32)
    neg_log_n = -torch.log(torch.tensor(float(N), dtype=torch.float32))
    return float(cst), float(thr_n), float(neg_log_n)


def _split_coef(coef_t: torch.Tensor, nx: int, ny: int):
    M = coef_t[:nx * nx].reshape(nx, nx)
    c = coef_t[nx * nx:nx * nx + nx]
    o = nx * nx + nx
    H = coef_t[o:o + ny * nx].reshape(ny, nx)
    d = coef_t[o + ny * nx:o + ny * nx + ny]
    return M, c, H, d


def pf_loglik_scan_plain(y, coef, L1, mu1, L2inv, mu2, L0, mu0, *, N: int,
                         thresh: float, seed: int, noise: str = "philox",
                         x0: Optional[torch.Tensor] = None):
    """The kernel's recursion as a loop of PyTorch ops (same order, same
    draws; only the order of the sums differs)."""
    T, ny = y.shape
    nx = L1.shape[0]
    dev = y.device
    cst, thr_n, neg_log_n = _scalars(L2inv, N, thresh)
    philox = noise == "philox"
    if x0 is not None:
        x = x0.to(torch.float32).clone()
    else:
        z = (normals_plain(seed, TAG_INIT, 0, N, nx, device=dev) if philox
             else torch.zeros(N, nx, device=dev))
        x = mu0 + z @ L0.T
    w = torch.full((N,), neg_log_n, dtype=torch.float32, device=dev)
    ll = torch.zeros((), dtype=torch.float32, device=dev)
    nres = 0
    missing = torch.isnan(y).any(-1).tolist()
    for t in range(T):
        M, c, H, d = _split_coef(coef[t], nx, ny)
        if missing[t]:
            w1 = w
        else:
            e = (y[t] - mu2) - (x @ H.T + d)
            z = e @ L2inv.T
            w1 = w + (cst - 0.5 * (z * z).sum(-1))
        m = w1.max()
        weu = torch.exp(w1 - m)
        s1 = weu.sum()
        s2 = (weu * weu).sum()
        ll_t = torch.zeros_like(m) if missing[t] else m + torch.log(s1)
        ll = ll + ll_t
        neff = 1.0 / (s2 / (s1 * s1))
        if thresh >= 1.0 or bool(neff < thr_n):
            r = (resample_offset_plain(seed, t, device=dev) if philox
                 else torch.tensor(0.5, device=dev))
            wi = torch.floor((weu / s1) * 16777216.0 + 0.5).to(torch.int64)
            C = torch.cumsum(wi, 0)
            scale = torch.tensor(float(N), dtype=torch.float32, device=dev) \
                / C[-1].to(torch.float32)
            K = torch.ceil(C.to(torch.float32) * scale - r).clamp_(0, N)
            x = x[slot_sources(K.to(torch.int32))]
            w = torch.full_like(w, neg_log_n)
            nres += 1
        else:
            w = w1 - ll_t
        z = (normals_plain(seed, TAG_PROPAGATE, t, N, nx, device=dev)
             if philox else torch.zeros_like(x))
        x = x @ M.T + c + mu1 + z @ L1.T
    return ll, torch.tensor(float(nres), device=dev)


def pf_loglik_scan(y, coef, L1, mu1, L2inv, mu2, L0, mu0, *, N: int,
                   thresh: float, seed: int, noise: str = "philox",
                   x0: Optional[torch.Tensor] = None):
    """Total log-likelihood and resample count of the bootstrap PF over
    ``y [T, ny]`` with per-step affine coefficients ``coef [T, S]``.
    Returns ``(ll, n_resamples)`` as f32 scalars on the device of ``y``.
    A CUDA ``y`` launches the cooperative kernel; a CPU ``y`` runs the
    plain twin."""
    if noise not in NOISE_MODES:
        raise ValueError(f"noise must be one of {NOISE_MODES}")
    if not y.is_cuda:
        return pf_loglik_scan_plain(y, coef, L1, mu1, L2inv, mu2, L0, mu0,
                                    N=N, thresh=thresh, seed=seed,
                                    noise=noise, x0=x0)
    T, ny = y.shape
    nx = L1.shape[0]
    if not (1 <= nx <= MAX_DIM and 1 <= ny <= MAX_DIM):
        raise ValueError(f"pf_loglik_scan: nx and ny must be in "
                         f"[1, {MAX_DIM}]")
    S = nx * nx + nx + ny * nx + ny
    for name, t, shape in (
            ("y", y, (T, ny)), ("coef", coef, (T, S)), ("L1", L1, (nx, nx)),
            ("mu1", mu1, (nx,)), ("L2inv", L2inv, (ny, ny)),
            ("mu2", mu2, (ny,)), ("L0", L0, (nx, nx)), ("mu0", mu0, (nx,))):
        require_cuda_f32(name, t, shape)
    if x0 is not None:
        require_cuda_f32("x0", x0, (N, nx))
    cst, thr_n, neg_log_n = _scalars(L2inv, N, thresh)
    lib = library().lib
    grid = torch.zeros(1, dtype=torch.int32)
    check(lib.llpf_pf_scan_grid(N, grid.data_ptr()), "pf_loglik_scan grid")
    G = int(grid[0])
    dev = y.device
    xa = torch.empty(nx * N, dtype=torch.float32, device=dev)
    xb = torch.empty_like(xa)
    w = torch.empty(N, dtype=torch.float32, device=dev)
    weu = torch.empty_like(w)
    kbuf = torch.empty(N, dtype=torch.int32, device=dev)
    part = torch.empty(3, G, dtype=torch.float32, device=dev)
    pint = torch.empty(G, dtype=torch.int32, device=dev)
    out = torch.empty(2, dtype=torch.float32, device=dev)
    check(lib.llpf_pf_loglik_scan(
        y.data_ptr(), coef.data_ptr(), L1.data_ptr(), mu1.data_ptr(),
        L2inv.data_ptr(), mu2.data_ptr(), L0.data_ptr(), mu0.data_ptr(),
        x0.data_ptr() if x0 is not None else None, xa.data_ptr(),
        xb.data_ptr(), w.data_ptr(), weu.data_ptr(), kbuf.data_ptr(),
        part[0].data_ptr(), part[1].data_ptr(), part[2].data_ptr(),
        pint.data_ptr(), out.data_ptr(), T, N, nx, ny, cst, thr_n, neg_log_n,
        int(thresh >= 1.0), int(noise == "philox"),
        int(seed) & (2**64 - 1), G, stream_ptr(y)), "pf_loglik_scan")
    PF_LOGLIK_SCAN.launches += 1
    return out[0], out[1]


# ---------------------------------------------------------------------------
# Admission and the per-step affine coefficients
# ---------------------------------------------------------------------------


def _probe_points(pf, dtype, device) -> list:
    """Two states at the scale the cloud reaches: ``mu0 + 4 σ0 ⊙ s1`` and
    ``mu0 + mu1 − 4 (σ0 + σ1) ⊙ s2``, with σ the marginal standard
    deviations of the initial and process densities and s fixed random
    sign vectors, so every coordinate sits four deviations out."""
    d0, d1 = pf.initial_density, pf.dynamics_density
    s0 = torch.sqrt(torch.diagonal(d0.cov)).to(device=device, dtype=dtype)
    s1 = torch.sqrt(torch.diagonal(d1.cov)).to(device=device, dtype=dtype)
    mu0 = d0.mean.to(device=device, dtype=dtype)
    mu1 = d1.mean.to(device=device, dtype=dtype)
    g = torch.Generator().manual_seed(0x5EED)
    sign = [(2 * torch.randint(0, 2, (pf.nx,), generator=g) - 1)
            .to(device=device, dtype=dtype) for _ in range(2)]
    return [mu0 + 4 * s0 * sign[0], mu0 + mu1 - 4 * (s0 + s1) * sign[1]]


def affine_coefficients(pf, u_seq: torch.Tensor, tvec: torch.Tensor
                        ) -> Optional[torch.Tensor]:
    """``[T, S]`` per-step (M_t, c_t, H_t, d_t) of the dynamics and
    measurement callbacks, or None when a probe finds either not affine
    in x.  The coefficients are taken at x = 0; at every step the
    Jacobian must be the same at the probe points (:func:`_probe_points`)
    and ``fn(x) == J x + fn(0)`` must hold there."""
    nx, T = pf.nx, u_seq.shape[0]
    dtype, dev = u_seq.dtype, u_seq.device
    p = pf.p
    vm = torch.func.vmap
    zero = torch.zeros(nx, dtype=dtype, device=dev)
    probes = _probe_points(pf, dtype, dev)
    cols = []
    for fn in (pf.dynamics, pf.measurement):
        h = lambda x, u, t: fn(x, u, p, t)
        jac_at = vm(torch.func.jacfwd(h), in_dims=(None, 0, 0))
        val_at = vm(h, in_dims=(None, 0, 0))
        J = jac_at(zero, u_seq, tvec).reshape(T, -1, nx)
        c = val_at(zero, u_seq, tvec).reshape(T, -1)
        for x in probes:
            if not torch.equal(jac_at(x, u_seq, tvec).reshape(J.shape), J):
                return None
            lin = J @ x + c
            tol = 1e-5 * (1.0 + lin.abs().amax(-1, keepdim=True))
            if bool(((val_at(x, u_seq, tvec).reshape(T, -1) - lin).abs()
                     > tol).any()):
                return None
        cols += [J.reshape(T, -1), c]
    return torch.cat(cols, 1).contiguous()


def pf_scan_supported(pf) -> bool:
    """Static admission (``pf_scan.py:350-373`` minus its VMEM terms):
    a bootstrap ``ParticleFilter``, Gaussian ``MvNormal`` dynamics,
    initial and measurement densities, systematic resampling, nx and ny
    at most 8.  The affine probes and the f32 check come on top, at call
    time (:func:`kernel_admits`)."""
    if type(pf) is not ParticleFilter:
        return False
    if pf.resampling_strategy != "systematic":
        return False
    dens = (pf.dynamics_density, pf.initial_density, pf.measurement_density)
    if not all(isinstance(d, MvNormal) for d in dens):
        return False
    return pf.nx <= MAX_DIM and pf.measurement_density.dim <= MAX_DIM


def _f32(*ts) -> bool:
    return all(t.dtype == torch.float32 for t in ts)


def scan_inputs(pf, u, y, coef: Optional[torch.Tensor] = None) -> list:
    """The f32 inputs ``(y, coef, L1, mu1, L2inv, mu2, L0, mu0)`` of
    :func:`pf_loglik_scan` for filter ``pf`` on the device of ``y``.
    ``coef`` may carry the coefficients :func:`kernel_admits` returned."""
    if coef is None:
        coef = kernel_admits(pf, u, y)
    if coef is None or not pf_scan_supported(pf):
        raise ValueError("kernel A does not admit this filter and data "
                         "(see kernel_admits)")
    d1, d2, d0 = (pf.dynamics_density, pf.measurement_density,
                  pf.initial_density)
    ny = y.shape[1]
    L2inv = tri_solve(chol_lower(d2.cov),
                      torch.eye(ny, dtype=d2.cov.dtype, device=d2.cov.device))
    return [t.to(device=y.device, dtype=torch.float32).contiguous() for t in (
        y, coef, d1.chol(), d1.mean, L2inv, d2.mean, d0.chol(), d0.mean)]


def pf_loglik_fused(pf, u, y, seed: int, *, x0=None, noise: str = "philox",
                    coef: Optional[torch.Tensor] = None):
    """Total bootstrap-PF log-likelihood of ``y`` in one kernel launch;
    returns ``(ll, n_resamples)``."""
    if x0 is not None:
        x0 = x0.to(device=y.device, dtype=torch.float32).contiguous()
    return pf_loglik_scan(*scan_inputs(pf, u, y, coef), N=pf.N,
                          thresh=float(pf.resample_threshold), seed=seed,
                          noise=noise, x0=x0)


def kernel_admits(pf, u, y) -> Optional[torch.Tensor]:
    """The coefficients when kernel A admits this call, else None:
    :func:`pf_scan_supported`, f32 data and densities, callbacks that the
    static walk finds affine in x (``ukf_scan.callbacks_affine``) and the
    probes of :func:`affine_coefficients` confirm."""
    if not pf_scan_supported(pf):
        return None
    dens = (pf.dynamics_density, pf.measurement_density, pf.initial_density)
    if not _f32(y, *[t for d in dens for t in (d.mean, d.cov)]):
        return None
    T = y.shape[0]
    u_seq = _as_u_seq(u, T, y.dtype, y.device)
    if not _f32(u_seq):
        return None
    # the static walk first: probes at a few states cannot see a clamp or
    # a branch on x; its verdict is kept per filter
    zero = torch.zeros((), dtype=torch.float32, device=y.device)
    if not callbacks_affine(pf, (pf.dynamics, pf.measurement),
                            zero.expand(pf.nx).clone(), u_seq[0], pf.p, zero):
        return None
    tvec = torch.arange(T, dtype=torch.float32, device=y.device) * pf.Ts
    return affine_coefficients(pf, u_seq, tvec)

