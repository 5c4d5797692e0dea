"""A bank of datasets through one shared linear Kalman filter
(counterpart of ``filters/bank.py``).

For a shared model the covariance recursion ``R⁺ = α·A(I − KC)RAᵀ + R1``,
``K = f(R)`` never sees the data, so it is computed once; each step's
correct + predict then folds into one affine map on the bank means,

    x⁺ = (A − A·K·C)·x + A·K·y + (B − A·K·D)·u,

and the whole bank advances on [B, nx] tensors.  ``kf_bank_loglik`` on
CUDA float32 runs the shared recursion through the temporal-parallel
plane pipeline (kernel K) and the bank recursion through kernel F
(kernels/bank_scan.py); ``method="plane"`` prefix-composes the affine
maps with a Hillis–Steele scan instead.

Admission: a plain ``KalmanFilter`` with a numeric ``alpha``; R12, the D
feedthrough and α-forgetting only enter the shared recursion.
"""
from __future__ import annotations

import torch

from ..ops.matrices import resolve_mat
from ..routing import _record, _under_batch_trace
from ..utils.struct import struct
from .kalman import kf_correct, kf_predict

__all__ = ["kf_bank_admissible", "kf_bank_loglik", "kf_bank_forward",
           "KFBankSolution"]

_LOG2PI = 1.8378770664093453
BANK_METHODS = ("auto", "kernel", "plane")


@struct
class KFBankSolution:
    """Bank forward pass: ``x``/``xt`` prior/filtered means [B, T, nx];
    ``R``/``Rt`` the shared prior/filtered covariances [T, nx, nx];
    ``ll`` [B]; ``e`` innovations [B, T, ny]."""

    x: torch.Tensor
    xt: torch.Tensor
    R: torch.Tensor
    Rt: torch.Tensor
    ll: torch.Tensor
    e: torch.Tensor


def kf_bank_admissible(kf) -> bool:
    """True when the shared-Riccati bank path applies: a plain
    ``KalmanFilter`` (its matrices are tensors, so nothing in the
    covariance recursion depends on a member's state) with a numeric
    ``alpha``."""
    from .kalman import KalmanFilter

    return type(kf) is KalmanFilter and isinstance(kf.alpha, (int, float))


def _resolve_stacked(M, T, n, m, dtype, device):
    """Matrix spec -> [T, n, m] stack (expanded constant, the first T
    steps of a time-stacked tensor, zeros for None)."""
    from ..parallel.temporal import _resolve_seq

    if M is None:
        return torch.zeros((T, n, m), dtype=dtype, device=device)
    return _resolve_seq(M, T).to(dtype=dtype, device=device)


def _shared_recursion(kf, T, dtype, device):
    """One pass of the data-independent covariance and gain recursion.

    Fast path (no R12, alpha = 1, nx, ny <= 8): the recursion is the
    data-independent half of the temporal-parallel filter, so it runs
    through ``_parallel_filter_core_p`` on zero data (kernel K on CUDA
    f32).  General path: ``kf_correct``/``kf_predict`` on a zero mean,
    step by step.  Returns ``(R_prior, Schol, K, R_filt, A, B, C, D)``
    stacked over T."""
    nx, ny = kf.nx, kf.ny
    nu = max(kf.nu, 0)
    zx = torch.zeros(nx, dtype=dtype, device=device)
    zy = torch.zeros(ny, dtype=dtype, device=device)
    P0 = kf.d0.cov.to(dtype=dtype, device=device)

    if kf.R12 is None and kf.alpha == 1.0 and nx <= 8 and ny <= 8:
        from ..parallel.temporal import _m_join, _parallel_filter_core_p

        A, B, C, D, Q, R2 = (
            _resolve_stacked(M, T, n, m, dtype, device)
            for M, n, m in ((kf.A, nx, nx), (kf.B, nx, nu), (kf.C, ny, nx),
                            (kf.D, ny, nu), (kf.R1, nx, nx),
                            (kf.R2, ny, ny)))
        _, Rpred, _, Ctp, _, _, Schp, Kp, _ = _parallel_filter_core_p(
            A, torch.zeros((T, nx), dtype=dtype, device=device), C, Q, R2,
            torch.zeros((T, ny), dtype=dtype, device=device), zx, P0)
        return (_m_join(Rpred), _m_join(Schp), _m_join(Kp), _m_join(Ctp),
                A, B, C, D)

    def at(M, tk, n, m):
        Mt = resolve_mat(M, zx, None, kf.p, tk, Ts=kf.Ts)
        if Mt is None:
            return torch.zeros((n, m), dtype=dtype, device=device)
        return Mt.to(dtype=dtype, device=device)

    R = P0
    out = []
    for k in range(T):
        tk = k * kf.Ts
        At, Bt, Ct, Dt = (at(kf.A, tk, nx, nx), at(kf.B, tk, nx, nu),
                          at(kf.C, tk, ny, nx), at(kf.D, tk, ny, nu))
        R12t = resolve_mat(kf.R12, zx, None, kf.p, tk, Ts=kf.Ts)
        if R12t is not None:
            R12t = R12t.to(dtype=dtype, device=device)
        _, Rf, info = kf_correct(zx, R, Ct, None, None, zy,
                                 at(kf.R2, tk, ny, ny), R12t)
        _, Rp = kf_predict(zx, Rf, At, None, None, at(kf.R1, tk, nx, nx),
                           kf.alpha)
        out.append((R, info.Schol, info.K, Rf, At, Bt, Ct, Dt))
        R = Rp
    return tuple(torch.stack(s) for s in zip(*out))


def _bank_inputs(kf, us, ys):
    if ys.ndim != 3:
        raise ValueError("kf_bank expects ys with shape [B, T, ny]")
    B, T, _ = ys.shape
    nu = max(kf.nu, 0)
    if us is None:
        us = ys.new_zeros((B, T, nu))
    else:
        us = torch.as_tensor(us, dtype=ys.dtype, device=ys.device)
        if us.ndim == 2:           # one input sequence for the whole bank
            us = us[None].expand(B, T, us.shape[-1])
    return us, ys, B, T


def _bank_loglik_planes(kf, us, ys, Bk, T, dtype, Schol, K, A, Bm, C, D):
    """Plane bank log-likelihood: the per-step operators as [T] planes,
    the data as [T, B] planes, and the mean recursion x⁺ = M_t x + d_t
    prefix-composed by a Hillis–Steele scan of the affine pairs."""
    from ..parallel.temporal import (_m_split, _mm_p, _msub_p, _mt_p,
                                     _trisolve_lower_p, associative_scan)

    nx, ny = kf.nx, kf.ny
    nu = us.shape[-1]
    Ap, Cp, Kp = _m_split(A), _m_split(C), _m_split(K)
    Schp = _m_split(Schol)
    eye_tt = tuple(tuple(1.0 if i == j else 0.0 for j in range(ny))
                   for i in range(ny))
    Linv = _trisolve_lower_p(Schp, eye_tt)
    AK = _mm_p(Ap, Kp)
    Mt = _msub_p(Ap, _mm_p(AK, Cp))
    W2 = _mm_p(_mt_p(Cp), _mt_p(Linv))
    cst = (-0.5 * ny * _LOG2PI
           + sum(torch.log(torch.abs(Linv[y][y])) for y in range(ny)))

    Y = tuple(ys[:, :, y].T for y in range(ny))
    U = tuple(us[:, :, u].T for u in range(nu))
    Z0 = [sum(Linv[z][y][:, None] * Y[y] for y in range(ny))
          for z in range(ny)]
    dr = [sum(AK[i][y][:, None] * Y[y] for y in range(ny))
          for i in range(nx)]
    if nu:
        Dp = _m_split(D)
        LD = _mm_p(Linv, Dp)
        BmAKD = _msub_p(_m_split(Bm), _mm_p(AK, Dp))
        Z0 = [z0 - sum(LD[z][u][:, None] * U[u] for u in range(nu))
              for z, z0 in enumerate(Z0)]
        dr = [d + sum(BmAKD[i][u][:, None] * U[u] for u in range(nu))
              for i, d in enumerate(dr)]

    def comb(e1, e2):
        A1, b1 = e1
        A2, b2 = e2
        return (_mm_p(A2, A1),
                tuple(sum(A2[i][q][:, None] * b1[q] for q in range(nx))
                      + b2[i] for i in range(nx)))

    A_, b_ = associative_scan(comb, (Mt, tuple(dr)))
    # the prior mean at step t is the exclusive prefix applied to x0
    x0 = kf.d0.mean.to(dtype=dtype, device=ys.device)
    sA = [sum(A_[i][j] * x0[j] for j in range(nx)) for i in range(nx)]
    Xq = [torch.cat([x0[i].expand(1, Bk), sA[i][:-1, None] + b_[i][:-1]])
          for i in range(nx)]
    lls = cst[:, None].expand(T, Bk)
    for y in range(ny):
        Z = Z0[y] - sum(Xq[i] * W2[i][y][:, None] for i in range(nx))
        lls = lls - 0.5 * Z * Z
    return lls.sum(0)


def _em(s, *xs):
    """einsum in float64, cast back: full precision whatever the TF32
    setting."""
    return torch.einsum(s, *(x.double() for x in xs)).to(xs[0].dtype)


def _bank_scan(kf, us, ys, want_states: bool, method: str = "auto"):
    """Shared precompute, then the bank recursion.  Returns ``(ll [B],
    x [B, T, nx], xt [B, T, nx], e [B, T, ny], R [T, nx, nx],
    Rt [T, nx, nx])``, the state outputs None without ``want_states``."""
    us, ys, Bk, T = _bank_inputs(kf, us, ys)
    dtype = ys.dtype
    nx, ny = kf.nx, kf.ny
    Rs, Schol, K, Rf, A, Bm, C, D = _shared_recursion(kf, T, dtype,
                                                      ys.device)
    if not want_states and nx <= 8 and ny <= 8:
        from ..kernels import bank_scan as bs

        nu = us.shape[-1]
        if method == "kernel":
            if not bs.bank_kernel_supported(T, Bk, nx, ny, nu, dtype):
                raise ValueError(
                    "bank kernel unsupported for this configuration (see "
                    "kernels/bank_scan.py::bank_kernel_supported)")
            use_kernel = True
        else:
            use_kernel = (method == "auto" and ys.is_cuda
                          and bs.bank_kernel_profitable(T, Bk, nx, ny, nu,
                                                        dtype))
        if use_kernel and not _under_batch_trace(kf, us, ys):
            ll = bs.bank_loglik_kernel(kf, us, ys, Schol, K, A, Bm, C, D)
            _record("kf_bank_loglik", "cuda_bank_kernel" if ys.is_cuda
                    else "bank_kernel_plain")
            return ll, None, None, None, Rs, Rf
        ll = _bank_loglik_planes(kf, us, ys, Bk, T, dtype, Schol, K, A, Bm,
                                 C, D)
        _record("kf_bank_loglik", "bank_plane")
        return ll, None, None, None, Rs, Rf

    eye = torch.eye(ny, dtype=torch.float64, device=ys.device)
    Linv = torch.linalg.solve_triangular(Schol.double(), eye.expand(
        T, ny, ny), upper=False).to(dtype)
    AK = _em("tij,tjk->tik", A, K)
    M = A - _em("tij,tjk->tik", AK, C)
    W2 = _em("tji,tkj->tik", C, Linv)
    cst = (-0.5 * ny * _LOG2PI
           + torch.log(torch.diagonal(Linv, dim1=-2, dim2=-1).abs()).sum(-1))
    Z0 = _em("bty,tzy->btz", ys, Linv)
    drive = _em("bty,tiy->bti", ys, AK)
    if us.shape[-1] > 0:
        Z0 = Z0 - _em("btu,tzy,tyu->btz", us, Linv, D)
        drive = drive + _em("btu,tiu->bti", us,
                            Bm - _em("tij,tju->tiu", AK, D))
    X = kf.d0.mean.to(dtype=dtype, device=ys.device).expand(Bk, nx)
    lls, Xp, Xf, E = [], [], [], []
    for t in range(T):
        Z = Z0[:, t] - _em("bi,iy->by", X, W2[t])
        lls.append(cst[t] - 0.5 * (Z * Z).sum(-1))
        if want_states:
            e = ys[:, t] - _em("bi,yi->by", X, C[t])
            if us.shape[-1] > 0:
                e = e - _em("bu,yu->by", us[:, t], D[t])
            Xp.append(X)
            Xf.append(X + _em("by,iy->bi", e, K[t]))
            E.append(e)
        X = _em("bi,ji->bj", X, M[t]) + drive[:, t]
    ll = torch.stack(lls).sum(0)
    if not want_states:
        _record("kf_bank_loglik", "bank_sequential")
        return ll, None, None, None, Rs, Rf
    return (ll, torch.stack(Xp, 1), torch.stack(Xf, 1), torch.stack(E, 1),
            Rs, Rf)


def kf_bank_loglik(kf, us, ys, method: str = "auto") -> torch.Tensor:
    """Per-member log-likelihood ``[B]`` of B datasets through one shared
    ``KalmanFilter``: ``vmap(lambda u, y: loglik(kf, u, y))(us, ys)`` with
    the Riccati recursion computed once.

    ``ys``: ``[B, T, ny]``; ``us``: ``[B, T, nu]``, a shared ``[T, nu]``,
    or None.  ``method``: ``"auto"`` (kernel F on CUDA float32 from 256
    members, the plane path otherwise), ``"kernel"`` (kernel F, its plain
    twin on CPU tensors; raises outside its gate) or ``"plane"``.
    ``last_route("kf_bank_loglik")`` names the path taken.
    """
    if method not in BANK_METHODS:
        raise ValueError(f"unknown bank method {method!r}")
    if not kf_bank_admissible(kf):
        us, ys, _, _ = _bank_inputs(kf, us, ys)
        ll = torch.func.vmap(lambda u, y: _vmap_loglik(kf, u, y))(us, ys)
        _record("kf_bank_loglik", "bank_vmap")
        return ll
    ll, *_ = _bank_scan(kf, us, ys, want_states=False, method=method)
    return ll


def kf_bank_forward(kf, us, ys) -> KFBankSolution:
    """The bank's forward pass (``forward_trajectory`` order: save the
    prediction, correct, save the filtered estimate): per-member means
    and innovations, and the shared covariances."""
    if not kf_bank_admissible(kf):
        raise ValueError(
            "kf_bank_forward needs a plain KalmanFilter with a numeric "
            "alpha (the shared-Riccati bank path); use "
            "parallel.bank.bank_forward_trajectory otherwise")
    ll, Xp, Xf, E, Rs, Rf = _bank_scan(kf, us, ys, want_states=True)
    return KFBankSolution(x=Xp, xt=Xf, R=Rs, Rt=Rf, ll=ll, e=E)


def _vmap_loglik(kf, u, y):
    from ..trajectory import loglik

    return loglik(kf, u, y)
