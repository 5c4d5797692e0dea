"""The whole bootstrap particle filter in one launch, kernel A
(counterpart of ``ops/pallas/pf_scan.py``: ``pf_loglik_fused``,
``pf_mean_fused``, ``pf_stats_fused``, ``pf_segment_fused``).

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

Modes (:func:`pf_scan`), each with its own launch counter:

- loglik: ``(ll, n_resamples)`` (``PF_LOGLIK_SCAN``, or
  ``PF_DENSITY_SCAN`` with a scalar-family measurement density);
- moments: also the filtered means ``[T, nx]`` and, with ``moments=2``,
  the central second moments ``[T, nx, nx]`` (``PF_MOMENTS_SCAN``);
- segment: from a given cloud ``x0`` and log-weights ``w0``, no
  resampling, returning the final cloud and log-weights
  (``PF_SEGMENT_SCAN``).

The measurement density is a Gaussian ``MvNormal`` (whitened) or, as
``pf_scan.py:297-347`` admits, a ``TupleProduct`` of (or a single one
of) the scalar families of ``ops/distributions.py`` with Python-number
parameters, whose constants :func:`density_constants` folds in float64.

``noise="none"`` is the JAX kernel's deterministic mode: no process
noise, resampling offset r = 0.5.  ``noise="philox"`` draws the initial
cloud, the process noise and r from Philox keyed by ``seed``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..filters.particle import ParticleFilter
from ..ops import distributions as dist
from ..ops.linalg import chol_lower, tri_solve
from ..ops.mvnormal import MvNormal
from ..trajectory import _as_u_seq
from ._lib import (KernelInfo, check, library, require_cuda_f32,
                   stream_ptr)
from .noise import (TAG_INIT, TAG_PROPAGATE, normals_plain,
                    resample_offset_plain)
from .resample_route import slot_sources
from .ukf_scan import callbacks_affine

_SRC = "lowlevelparticlefilters_jl_tpu_torch/csrc/pf_scan.cu"
_JAX = "lowlevelparticlefilters_jl_tpu/ops/pallas/pf_scan.py"
PF_LOGLIK_SCAN = KernelInfo("pf_loglik_scan", _SRC, f"{_JAX}:747")
PF_MOMENTS_SCAN = KernelInfo("pf_moments_scan", _SRC, f"{_JAX}:978")
PF_SEGMENT_SCAN = KernelInfo("pf_segment_scan", _SRC, f"{_JAX}:835")
PF_DENSITY_SCAN = KernelInfo("pf_density_scan", _SRC, f"{_JAX}:905")

_LOG2PI = 1.8378770664093453
NOISE_MODES = ("philox", "none")
MAX_DIM = 8
#: kernel family codes of the scalar densities (csrc/pf_scan.cu)
FAMILY = {cls: code for code, cls in enumerate(dist.SCALAR_FAMILIES, 1)}
DENS_CONSTS = 6

def _scalar_dists(d) -> Optional[list]:
    """The scalar components of an admitted measurement density (a
    ``TupleProduct`` of, or a single one of, the scalar families with
    Python-number parameters only), else None — ``_meas_density_kernel_ok``
    of the JAX package."""
    comps = list(d.dists) if isinstance(d, dist.TupleProduct) else [d]
    for c in comps:
        if type(c) not in FAMILY or not all(
                isinstance(getattr(c, f.name), (int, float))
                for f in dataclasses.fields(c)):
            return None
    return comps


def _fold(c) -> list:
    """The kernel's constants of one scalar density, in float64."""
    if isinstance(c, dist.Normal):
        return [c.mu, 1 / c.sigma, -0.5 * _LOG2PI - math.log(c.sigma)]
    if isinstance(c, dist.Uniform):
        return [c.lo, c.hi, -math.log(c.hi - c.lo)]
    if isinstance(c, dist.Laplace):
        return [c.mu, 1 / c.b, -math.log(2 * c.b)]
    if isinstance(c, dist.StudentT):
        v = c.df
        return [c.mu, 1 / c.sigma,
                math.lgamma((v + 1) / 2) - math.lgamma(v / 2)
                - 0.5 * math.log(v * math.pi) - math.log(c.sigma),
                (v + 1) / 2, 1 / v]
    if isinstance(c, dist.Binary):
        return [c.a, c.b, math.log(c.pa), math.log1p(-c.pa)]
    return [c.mu1, 1 / c.sigma1,
            -0.5 * _LOG2PI - math.log(c.sigma1) + math.log(c.p1),
            c.mu2, 1 / c.sigma2,
            -0.5 * _LOG2PI - math.log(c.sigma2) + math.log1p(-c.p1)]


def density_constants(d, device=None):
    """``(kinds int32 [ny], consts f32 [ny, 6])`` of a scalar-family
    measurement density: per dimension its family code and up to six
    constants folded in float64 (StudentT's lgamma terms among them)."""
    comps = _scalar_dists(d)
    if comps is None:
        raise ValueError("not a scalar-family density with Python-number "
                         "parameters")
    consts = torch.zeros(len(comps), DENS_CONSTS, dtype=torch.float64)
    for k, c in enumerate(comps):
        v = _fold(c)
        consts[k, :len(v)] = torch.tensor(v, dtype=torch.float64)
    kinds = torch.tensor([FAMILY[type(c)] for c in comps], dtype=torch.int32)
    return kinds.to(device), consts.to(device=device, dtype=torch.float32)


def scalar_logpdf_plain(kinds, consts, e: torch.Tensor) -> torch.Tensor:
    """``Σ_d logpdf_d(e[..., d])`` from the folded constants, in f32, as
    the kernel evaluates it."""
    lp = torch.zeros(e.shape[:-1], dtype=e.dtype, device=e.device)
    ninf = torch.tensor(-math.inf, dtype=e.dtype, device=e.device)
    for d, kind in enumerate(kinds.tolist()):
        c = [float(v) for v in consts[d]]
        x = e[..., d]
        if kind == FAMILY[dist.Normal]:
            z = (x - c[0]) * c[1]
            v = c[2] - 0.5 * (z * z)
        elif kind == FAMILY[dist.Uniform]:
            v = torch.where((x >= c[0]) & (x <= c[1]),
                            torch.full_like(x, c[2]), ninf)
        elif kind == FAMILY[dist.Laplace]:
            v = c[2] - (x - c[0]).abs() * c[1]
        elif kind == FAMILY[dist.StudentT]:
            z = (x - c[0]) * c[1]
            v = c[2] - c[3] * torch.log1p((z * z) * c[4])
        elif kind == FAMILY[dist.Binary]:
            tol = [torch.tensor(1e-8, dtype=x.dtype)
                   + torch.tensor(1e-5, dtype=x.dtype) * abs(ab)
                   for ab in (torch.tensor(c[0], dtype=x.dtype),
                              torch.tensor(c[1], dtype=x.dtype))]
            is_a = (x == c[0]) | ((x - c[0]).abs() <= tol[0])
            is_b = (x == c[1]) | ((x - c[1]).abs() <= tol[1])
            v = torch.where(is_a, torch.full_like(x, c[2]),
                            torch.where(is_b, torch.full_like(x, c[3]),
                                        ninf))
        else:
            z1, z2 = (x - c[0]) * c[1], (x - c[3]) * c[4]
            l1, l2 = c[2] - 0.5 * (z1 * z1), c[5] - 0.5 * (z2 * z2)
            v = torch.maximum(l1, l2) + torch.log1p(
                torch.exp(-(l1 - l2).abs()))
        lp = lp + v
    return lp


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


def _kernel_info(moments: int, segment: bool, dens) -> KernelInfo:
    if segment:
        return PF_SEGMENT_SCAN
    if moments:
        return PF_MOMENTS_SCAN
    return PF_LOGLIK_SCAN if dens is None else PF_DENSITY_SCAN


def pf_scan_plain(y, coef, L1, mu1, L2inv, mu2, L0, mu0, *, N: int,
                  thresh: float, seed: int, noise: str = "philox",
                  x0: Optional[torch.Tensor] = None,
                  w0: Optional[torch.Tensor] = None, dens=None,
                  moments: int = 0, segment: bool = False) -> dict:
    """The kernel's recursion as a loop of PyTorch ops (same order, same
    draws; only the order of the sums differs).  See :func:`pf_scan`."""
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
    w = (w0.to(torch.float32).clone() if w0 is not None else
         torch.full((N,), neg_log_n, dtype=torch.float32, device=dev))
    ll = torch.zeros((), dtype=torch.float32, device=dev)
    nres = 0
    means, covs = [], []
    missing = torch.isnan(y).any(-1).tolist()
    for t in range(T):
        M, c, H, d = _split_coef(coef[t], nx, ny)
        if missing[t]:
            w1 = w
        elif dens is not None:
            w1 = w + scalar_logpdf_plain(*dens, y[t] - (x @ H.T + d))
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
        if moments:
            mean = (weu @ x) / s1
            means.append(mean)
            if moments == 2:
                dx = x - mean
                covs.append(((weu[:, None] * dx).T @ dx) / s1)
        neff = 1.0 / (s2 / (s1 * s1))
        if not segment and (thresh >= 1.0 or bool(neff < thr_n)):
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
    out = dict(ll=ll, nres=torch.tensor(float(nres), device=dev))
    if moments:
        out["means"] = (torch.stack(means) if T else
                        torch.zeros(0, nx, device=dev))
    if moments == 2:
        out["covs"] = (torch.stack(covs) if T else
                       torch.zeros(0, nx, nx, device=dev))
    if segment:
        out.update(x_fin=x, w_fin=w)
    return out


def pf_scan(y, coef, L1, mu1, L2inv, mu2, L0, mu0, *, N: int, thresh: float,
            seed: int, noise: str = "philox",
            x0: Optional[torch.Tensor] = None,
            w0: Optional[torch.Tensor] = None, dens=None, moments: int = 0,
            segment: bool = False) -> dict:
    """The bootstrap PF over ``y [T, ny]`` with per-step affine
    coefficients ``coef [T, S]``, as one launch of kernel A on a CUDA
    ``y`` (its plain twin on a CPU ``y``).  Returns a dict of f32
    tensors: ``ll`` and ``nres`` (resamples) always; ``means [T, nx]``
    with ``moments`` 1 or 2, ``covs [T, nx, nx]`` (central) with 2;
    ``x_fin [N, nx]`` and ``w_fin [N]`` with ``segment``, which starts
    from the cloud ``x0`` and log-weights ``w0`` and never resamples.
    ``dens`` = :func:`density_constants` weights by a scalar-family
    density of ``y - ŷ`` instead of the Gaussian (L2inv, mu2)."""
    if noise not in NOISE_MODES:
        raise ValueError(f"noise must be one of {NOISE_MODES}")
    if moments not in (0, 1, 2):
        raise ValueError("moments must be 0, 1 or 2")
    if segment and (x0 is None or w0 is None):
        raise ValueError("segment mode needs x0 and w0")
    kw = dict(N=N, thresh=thresh, seed=seed, noise=noise, x0=x0, w0=w0,
              dens=dens, moments=moments, segment=segment)
    if not y.is_cuda:
        return pf_scan_plain(y, coef, L1, mu1, L2inv, mu2, L0, mu0, **kw)
    T, ny = y.shape
    nx = L1.shape[0]
    if not (1 <= nx <= MAX_DIM and 1 <= ny <= MAX_DIM):
        raise ValueError(f"pf_scan: nx and ny must be in [1, {MAX_DIM}]")
    S = nx * nx + nx + ny * nx + ny
    for name, t, shape in (
            ("y", y, (T, ny)), ("coef", coef, (T, S)), ("L1", L1, (nx, nx)),
            ("mu1", mu1, (nx,)), ("L2inv", L2inv, (ny, ny)),
            ("mu2", mu2, (ny,)), ("L0", L0, (nx, nx)), ("mu0", mu0, (nx,))):
        require_cuda_f32(name, t, shape)
    if x0 is not None:
        require_cuda_f32("x0", x0, (N, nx))
    if w0 is not None:
        require_cuda_f32("w0", w0, (N,))
    if dens is not None:
        kinds, consts = dens
        require_cuda_f32("density constants", consts, (ny, DENS_CONSTS))
        if not kinds.is_cuda or kinds.dtype != torch.int32 \
                or tuple(kinds.shape) != (ny,):
            raise ValueError("density kinds must be a CUDA int32 [ny] tensor")
    cst, thr_n, neg_log_n = _scalars(L2inv, N, thresh)
    mode = (1 if moments else 0) | (2 if dens is not None else 0)
    lib = library().lib
    grid = torch.zeros(1, dtype=torch.int32)
    check(lib.llpf_pf_scan_grid(N, mode, grid.data_ptr()), "pf_scan grid")
    G = int(grid[0])
    dev = y.device
    f32 = dict(dtype=torch.float32, device=dev)
    xa = torch.empty(nx * N, **f32)
    xb = torch.empty_like(xa)
    w = torch.empty(N, **f32)
    weu = torch.empty_like(w)
    kbuf = torch.empty(N, dtype=torch.int32, device=dev)
    part = torch.empty(3, G, **f32)
    pint = torch.empty(G, dtype=torch.int32, device=dev)
    res = torch.empty(2, **f32)
    out = {}
    if moments:
        out["means"] = torch.empty(T, nx, **f32)
    if moments == 2:
        out["covs"] = torch.empty(T, nx, nx, **f32)
    pmom = (torch.empty(nx + nx * (nx + 1) // 2, G, **f32) if moments
            else None)
    if segment:
        out.update(x_fin=torch.empty(N, nx, **f32), w_fin=torch.empty(N, **f32))
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    check(lib.llpf_pf_scan(
        y.data_ptr(), coef.data_ptr(), L1.data_ptr(), mu1.data_ptr(),
        L2inv.data_ptr(), mu2.data_ptr(), L0.data_ptr(), mu0.data_ptr(),
        ptr(x0), ptr(w0), *(ptr(t) for t in (dens or (None, None))),
        xa.data_ptr(), xb.data_ptr(), w.data_ptr(), weu.data_ptr(),
        kbuf.data_ptr(), part[0].data_ptr(), part[1].data_ptr(),
        part[2].data_ptr(), pint.data_ptr(), ptr(pmom), res.data_ptr(),
        ptr(out.get("means")), ptr(out.get("covs")), ptr(out.get("x_fin")),
        ptr(out.get("w_fin")), T, N, nx, ny, cst, thr_n, neg_log_n,
        int(thresh >= 1.0), int(noise == "philox"), int(segment),
        int(moments == 2), mode, int(seed) & (2**64 - 1), G,
        stream_ptr(y)), "pf_scan")
    _kernel_info(moments, segment, dens).launches += 1
    return dict(ll=res[0], nres=res[1], **out)


def pf_loglik_scan_plain(*args, **kw):
    """``(ll, n_resamples)`` of :func:`pf_scan_plain` in loglik mode."""
    out = pf_scan_plain(*args, **kw)
    return out["ll"], out["nres"]


def pf_loglik_scan(*args, **kw):
    """``(ll, n_resamples)`` of :func:`pf_scan` in loglik mode (kernel A
    on a CUDA ``y``)."""
    out = pf_scan(*args, **kw)
    return out["ll"], out["nres"]


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
    a bootstrap ``ParticleFilter``, Gaussian ``MvNormal`` dynamics and
    initial densities, a Gaussian or admitted scalar-family measurement
    density (:func:`density_constants`), systematic resampling, nx and ny
    at most 8.  The affine probes and the f32 check come on top, at call
    time (:func:`kernel_admits`)."""
    if type(pf) is not ParticleFilter:
        return False
    if pf.resampling_strategy != "systematic":
        return False
    if not all(isinstance(d, MvNormal)
               for d in (pf.dynamics_density, pf.initial_density)):
        return False
    dm = pf.measurement_density
    if isinstance(dm, MvNormal):
        ny = dm.dim
    else:
        comps = _scalar_dists(dm)
        if comps is None:
            return False
        ny = len(comps)
    return pf.nx <= MAX_DIM and ny <= MAX_DIM


def _f32(*ts) -> bool:
    return all(t.dtype == torch.float32 for t in ts)


def scan_inputs(pf, u, y, coef: Optional[torch.Tensor] = None) -> list:
    """The f32 inputs ``(y, coef, L1, mu1, L2inv, mu2, L0, mu0)`` of
    :func:`pf_scan` for filter ``pf`` on the device of ``y`` (with a
    scalar-family measurement density, L2inv = I and mu2 = 0 stand in).
    ``coef`` may carry the coefficients :func:`kernel_admits` returned."""
    if coef is None:
        coef = kernel_admits(pf, u, y)
    if coef is None or not pf_scan_supported(pf):
        raise ValueError("kernel A does not admit this filter and data "
                         "(see kernel_admits)")
    d1, d2, d0 = (pf.dynamics_density, pf.measurement_density,
                  pf.initial_density)
    ny = y.shape[1]
    if isinstance(d2, MvNormal):
        L2inv = tri_solve(chol_lower(d2.cov), torch.eye(
            ny, dtype=d2.cov.dtype, device=d2.cov.device))
        mu2 = d2.mean
    else:
        L2inv, mu2 = torch.eye(ny), torch.zeros(ny)
    return [t.to(device=y.device, dtype=torch.float32).contiguous() for t in (
        y, coef, d1.chol(), d1.mean, L2inv, mu2, d0.chol(), d0.mean)]


def scan_density(pf, device):
    """:func:`density_constants` of a scalar-family measurement density,
    or None for a Gaussian one."""
    d = pf.measurement_density
    return None if isinstance(d, MvNormal) else density_constants(d, device)


def _fused(pf, u, y, seed, x0, noise, coef, **mode) -> dict:
    if x0 is not None:
        x0 = x0.to(device=y.device, dtype=torch.float32).contiguous()
    w0 = mode.pop("w0", None)
    if w0 is not None:
        w0 = w0.to(device=y.device, dtype=torch.float32).contiguous()
    N = x0.shape[0] if mode.get("segment") else pf.N
    return pf_scan(*scan_inputs(pf, u, y, coef), N=N,
                   thresh=float(pf.resample_threshold), seed=seed,
                   noise=noise, x0=x0, w0=w0,
                   dens=scan_density(pf, y.device), **mode)


def pf_loglik_fused(pf, u, y, seed: int, *, x0=None, noise: str = "philox",
                    coef: Optional[torch.Tensor] = None):
    """Total bootstrap-PF log-likelihood of ``y`` in one kernel launch;
    returns ``(ll, n_resamples)``."""
    out = _fused(pf, u, y, seed, x0, noise, coef)
    return out["ll"], out["nres"]


def pf_mean_fused(pf, u, y, seed: int, *, x0=None, noise: str = "philox",
                  coef: Optional[torch.Tensor] = None):
    """The filtered (weighted) means ``[T, nx]`` of every step, with
    ``(ll, n_resamples)``, from one kernel launch: the state-tracking
    counterpart of ``forward_trajectory`` + ``weighted_mean`` without
    the [T, N, nx] cloud.  Returns ``(means, ll, n_resamples)``."""
    out = _fused(pf, u, y, seed, x0, noise, coef, moments=1)
    return out["means"], out["ll"], out["nres"]


def pf_stats_fused(pf, u, y, seed: int, *, x0=None, noise: str = "philox",
                   coef: Optional[torch.Tensor] = None):
    """The filtered means ``[T, nx]`` and covariances ``[T, nx, nx]``
    (``Σ wᵉ (x − m)(x − m)ᵀ``, centred in the kernel) of every step, with
    ``(ll, n_resamples)``, from one launch.  Returns ``(means, covs, ll,
    n_resamples)``."""
    out = _fused(pf, u, y, seed, x0, noise, coef, moments=2)
    return out["means"], out["covs"], out["ll"], out["nres"]


def pf_segment_fused(pf, u, y, seed: int, x0, w0, *, noise: str = "philox",
                     coef: Optional[torch.Tensor] = None):
    """One resampling-free stretch of the PF from the cloud ``x0
    [Nloc, nx]`` and log-weights ``w0 [Nloc]``: weights are normalized
    locally each step and the subtracted ``ll_t`` summed, so the carried
    unnormalized weights are ``w_fin + ll_local``.  The building block of
    the particle-sharded PF.  Returns ``(ll_local, x_fin, w_fin)``."""
    out = _fused(pf, u, y, seed, x0, noise, coef, w0=w0, segment=True)
    return out["ll"], out["x_fin"], out["w_fin"]


def kernel_admits(pf, u, y) -> Optional[torch.Tensor]:
    """The coefficients when kernel A admits this call, else None:
    :func:`pf_scan_supported`, f32 data and Gaussian densities, a scalar
    density's dimension equal to ny, callbacks that the static walk finds
    affine in x (``ukf_scan.callbacks_affine``) and the probes of
    :func:`affine_coefficients` confirm."""
    if not pf_scan_supported(pf):
        return None
    dens = [d for d in (pf.dynamics_density, pf.measurement_density,
                        pf.initial_density) if isinstance(d, MvNormal)]
    if not _f32(y, *[t for d in dens for t in (d.mean, d.cov)]):
        return None
    dm = pf.measurement_density
    if (dm.dim if isinstance(dm, MvNormal) else len(_scalar_dists(dm))) \
            != y.shape[1]:
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
