"""Shared-Riccati KF bank log-likelihood, kernel F (counterpart of
``ops/pallas/bank_scan.py``).

``filters/bank.py`` runs B datasets through one ``KalmanFilter`` with the
covariance recursion computed once.  What is left per member is the
mean recursion: per step t,

    Z  = Linv_t y − LD_t u − W2_tᵀ x,   ll −= ½‖Z‖²,
    x ← M_t x + AK_t y + BmAKD_t u,

with the per-step scalars built here from the shared recursion's
output.  They are computed in float64 and cast, so the result does not
depend on PyTorch's TF32 setting.  :func:`bank_loglik_scan` runs the
T-step loop: ``csrc/bank_scan.cu`` on CUDA tensors, the plain twin (the
same loop over [B] tensors, in the same order) on the CPU.
"""
from __future__ import annotations

import torch

from ..ops.linalg import tri_solve
from ._lib import KernelInfo, check, library, require_cuda_f32, stream_ptr

BANK_LOGLIK = KernelInfo(
    "bank_loglik", "lowlevelparticlefilters_jl_tpu_torch/csrc/bank_scan.cu",
    "lowlevelparticlefilters_jl_tpu/ops/pallas/bank_scan.py:200")

_LOG2PI = 1.8378770664093453
MAX_DIM = 4


def bank_kernel_supported(T: int, B: int, nx: int, ny: int, nu: int,
                          dtype) -> bool:
    """What kernel F can run (``method="kernel"`` honours exactly this):
    float32 and nx, ny, nu <= 4."""
    return (dtype == torch.float32 and 1 <= nx <= MAX_DIM
            and 1 <= ny <= MAX_DIM and 0 <= nu <= MAX_DIM)


def bank_kernel_profitable(T: int, B: int, nx: int, ny: int, nu: int,
                           dtype) -> bool:
    """The auto route's gate: supported, and at least 256 members (below
    that the plane path is already cheap)."""
    return B >= 256 and bank_kernel_supported(T, B, nx, ny, nu, dtype)


def bank_scalars(Schol, K, A, Bm, C, D, nu: int):
    """Per-step scalars ``[T, S]`` f32 (M | AK | Linv | W2 | BmAKD | LD,
    each block row-major) and the f64 constant Σ_t (log|det Linv_t| −
    ny/2 log 2π), from the shared recursion's [T, ...] stacks."""
    Schol, K, A, C = (t.double() for t in (Schol, K, A, C))
    T, ny = Schol.shape[0], Schol.shape[-1]
    nx = A.shape[-1]
    eye = torch.eye(ny, dtype=torch.float64, device=Schol.device)
    Linv = tri_solve(Schol, eye.expand(T, ny, ny), lower=True)
    AK = A @ K
    M = A - AK @ C
    W2 = C.mT @ Linv.mT
    cst = (-0.5 * ny * _LOG2PI * T
           + torch.log(torch.diagonal(Linv, dim1=-2, dim2=-1).abs()).sum())
    cols = [M.reshape(T, nx * nx), AK.reshape(T, nx * ny),
            Linv.reshape(T, ny * ny), W2.reshape(T, nx * ny)]
    if nu:
        Bm, D = Bm.double(), D.double()
        cols += [(Bm - AK @ D).reshape(T, nx * nu),
                 (Linv @ D).reshape(T, ny * nu)]
    return torch.cat(cols, 1).float().contiguous(), cst


def _offsets(nx: int, ny: int, nu: int):
    oAK = nx * nx
    oLi = oAK + nx * ny
    oW2 = oLi + ny * ny
    oBD = oW2 + nx * ny
    return oAK, oLi, oW2, oBD, oBD + nx * nu


def bank_loglik_scan_plain(scal, ys, us, x0, nx: int, ny: int, nu: int):
    """The kernel's loop over [B] tensors, in its order of operations."""
    oAK, oLi, oW2, oBD, oLD = _offsets(nx, ny, nu)
    Bk, T = ys.shape[0], ys.shape[1]
    X = [x0[i].expand(Bk) for i in range(nx)]
    acc = ys.new_zeros(Bk)
    for t in range(T):
        s = scal[t]
        Y = [ys[:, t, j] for j in range(ny)]
        U = [us[:, t, j] for j in range(nu)]
        dll = ys.new_zeros(Bk)
        for z in range(ny):
            a = ys.new_zeros(Bk)
            for j in range(ny):
                a = a + s[oLi + z * ny + j] * Y[j]
            for j in range(nu):
                a = a - s[oLD + z * nu + j] * U[j]
            for i in range(nx):
                a = a - s[oW2 + i * ny + z] * X[i]
            dll = dll - 0.5 * a * a
        acc = acc + dll
        Xn = []
        for i in range(nx):
            a = ys.new_zeros(Bk)
            for j in range(nx):
                a = a + s[i * nx + j] * X[j]
            for j in range(ny):
                a = a + s[oAK + i * ny + j] * Y[j]
            for j in range(nu):
                a = a + s[oBD + i * nu + j] * U[j]
            Xn.append(a)
        X = Xn
    return acc


def bank_loglik_scan(scal, ys, us, x0, nx: int, ny: int, nu: int):
    """Σ_t −½‖Z_t‖² per member ``[B]`` (without the constant):
    ``scal [T, S]``, ``ys [B, T, ny]``, ``us [B, T, nu]`` (a shared input
    may have member stride 0), ``x0 [nx]``."""
    if not ys.is_cuda:
        return bank_loglik_scan_plain(scal, ys, us, x0, nx, ny, nu)
    Bk, T, _ = ys.shape
    if not bank_kernel_supported(T, Bk, nx, ny, nu, ys.dtype):
        raise ValueError("bank_loglik: needs float32 and nx, ny, nu <= 4")
    S = scal.shape[1]
    require_cuda_f32("scalars", scal, (T, S))
    require_cuda_f32("ys", ys, (Bk, T, ny))
    require_cuda_f32("x0", x0, (nx,))
    us_ptr, us_b = 0, 0
    if nu:
        if us.stride(0) == 0:
            us = us[0].contiguous()
            require_cuda_f32("us", us, (T, nu))
        else:
            us = us.contiguous()
            require_cuda_f32("us", us, (Bk, T, nu))
            us_b = T * nu
        us_ptr = us.data_ptr()
    ll = torch.empty(Bk, dtype=torch.float32, device=ys.device)
    check(library().lib.llpf_bank_loglik(
        scal.data_ptr(), S, ys.data_ptr(), us_ptr, us_b, x0.data_ptr(),
        ll.data_ptr(), Bk, T, nx, ny, nu, stream_ptr(ys)), "bank_loglik")
    BANK_LOGLIK.launches += 1
    return ll


def bank_loglik_kernel(kf, us, ys, Schol, K, A, Bm, C, D):
    """Bank log-likelihood ``[B]`` through kernel F (its plain twin on CPU
    tensors).  Inputs follow ``filters/bank.py::_bank_scan``: ``ys [B, T,
    ny]``, ``us [B, T, nu]`` and the shared recursion's [T, ...] stacks."""
    nu = us.shape[-1]
    scal, cst = bank_scalars(Schol, K, A, Bm, C, D, nu)
    x0 = kf.d0.mean.to(dtype=torch.float32, device=ys.device).contiguous()
    ll = bank_loglik_scan(scal, ys.float(), us.float(), x0, kf.nx,
                          ys.shape[-1], nu)
    return ll + cst.float()
