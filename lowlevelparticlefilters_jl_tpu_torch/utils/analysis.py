"""Linear-systems analysis of filters (counterpart of ``utils/analysis.py``).

Linearization of any filter (``torch.func.jacfwd``; a linear filter's
matrices are resolved as they are), the observability and
controllability matrices and their ranks, the stationary Kalman gain
from a fixed number of Riccati steps, and the stationary state
covariance from the discrete Lyapunov equation by doubling.  The
iteration counts are the JAX package's, so both compute the same fixed
point to the same truncation.  Tensors stay on the device of the inputs;
arrays and lists go to the device of the tensors among them, or to the
card when there are none (``kernels/_lib.as_tensors``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..kernels._lib import as_tensors, default_device
from ..ops.linalg import symmetrize
from ..ops.matrices import resolve_mat


def linearize(f, x, u, p=None, t=0.0):
    """``(A, B, C, D)`` of the filter's model at ``(x, u, p, t)``.  Linear
    filters resolve their matrices; the others are differentiated with
    ``torch.func.jacfwd``."""
    p = getattr(f, "p", None) if p is None else p
    x, u = as_tensors(x, u, like=f)
    Ts = getattr(f, "Ts", 1.0)
    if hasattr(f, "A") and not callable(getattr(f, "dynamics", None)):
        return tuple(resolve_mat(M, x, u, p, t, Ts=Ts)
                     for M in (f.A, f.B, f.C, f.D))
    dyn = f.dynamics if callable(getattr(f, "dynamics", None)) \
        else f.dynamics_fn()
    if hasattr(f, "measurement_model"):
        meas = f.measurement_model.measurement
    elif callable(getattr(f, "measurement", None)):
        meas = f.measurement
    else:
        meas = f.measurement_fn()
    jac = torch.func.jacfwd
    A = jac(lambda xx: dyn(xx, u, p, t))(x)
    B = jac(lambda uu: dyn(x, uu, p, t))(u)
    C = jac(lambda xx: meas(xx, u, p, t))(x)
    D = jac(lambda uu: meas(x, uu, p, t))(u)
    return A, B, C, D


def linearize_noise_input(f, x, u, p=None, t=0.0):
    """``(A, Bw)`` of the augmented-noise dynamics ``f(x, u, p, t, w)`` at
    w = 0."""
    p = getattr(f, "p", None) if p is None else p
    x, u = as_tensors(x, u, like=f)
    w0 = torch.zeros((f.nw,), dtype=x.dtype, device=x.device)
    A = torch.func.jacfwd(lambda xx: f.dynamics(xx, u, p, t, w0))(x)
    Bw = torch.func.jacfwd(lambda ww: f.dynamics(x, u, p, t, ww))(w0)
    return A, Bw


def obsv(A, C, n: Optional[int] = None) -> torch.Tensor:
    """The observability matrix ``[C; CA; ...; CA^(n-1)]``."""
    A, C = as_tensors(A, C)
    n = A.shape[-1] if n is None else n
    rows = [C]
    for _ in range(n - 1):
        rows.append(rows[-1] @ A)
    return torch.cat(rows, dim=0)


def ctrb(A, B, n: Optional[int] = None) -> torch.Tensor:
    """The controllability matrix ``[B, AB, ..., A^(n-1)B]``."""
    A, B = as_tensors(A, B)
    n = A.shape[-1] if n is None else n
    cols = [B]
    for _ in range(n - 1):
        cols.append(A @ cols[-1])
    return torch.cat(cols, dim=1)


def observability(f, x, u, p=None, t=0.0) -> dict:
    """The linearized filter's observability matrix, its rank and the
    verdict."""
    A, _, C, _ = linearize(f, x, u, p, t)
    O = obsv(A, C)
    r = int(torch.linalg.matrix_rank(O))
    return {"matrix": O, "rank": r, "isobservable": r == A.shape[-1]}


def controllability(f, x, u, p=None, t=0.0, *,
                    from_noise: bool = False) -> dict:
    """The controllability matrix, its rank and the verdict;
    ``from_noise=True`` analyzes reachability from the (augmented) noise
    input."""
    if from_noise:
        A, B = linearize_noise_input(f, x, u, p, t)
    else:
        A, B, _, _ = linearize(f, x, u, p, t)
    Cm = ctrb(A, B)
    r = int(torch.linalg.matrix_rank(Cm))
    return {"matrix": Cm, "rank": r, "iscontrollable": r == A.shape[-1]}


def _gain(P, C, R2):
    S = C @ P @ C.T + R2
    return torch.linalg.solve(S.T, (P @ C.T).T).T


def dare(A, C, R1, R2, *, iters: int = 200) -> torch.Tensor:
    """The stationary predictive covariance: ``iters`` steps of the
    Riccati recursion from R1,
    ``P = A(P − PCᵀ(CPCᵀ+R2)⁻¹CP)Aᵀ + R1``."""
    A, C, R1, R2 = as_tensors(A, C, R1, R2)
    P = R1
    for _ in range(iters):
        K = _gain(P, C, R2)
        P = symmetrize(A @ (P - K @ C @ P) @ A.T) + R1
    return P


def kalman_gain(f_or_A, x=None, u=None, p=None, t=0.0, *, C=None, R1=None,
                R2=None, iters: int = 200):
    """The stationary Kalman gain ``K = PCᵀ(CPCᵀ+R2)⁻¹``: of a filter at
    an operating point, or of matrices, ``kalman_gain(A, C=C, R1=R1,
    R2=R2)``."""
    if C is None:
        f = f_or_A
        A, _, C, _ = linearize(f, x, u, p, t)
        Ts = getattr(f, "Ts", 1.0)
        R1 = resolve_mat(f.R1, x, u, p, t, Ts=Ts)
        R2 = resolve_mat(f.R2, x, u, p, t, Ts=Ts)
    else:
        A, C, R1, R2 = as_tensors(f_or_A, C, R1, R2)
    return _gain(dare(A, C, R1, R2, iters=iters), C, R2)


def dlyap(A, Q, *, iters: int = 200) -> torch.Tensor:
    """The discrete Lyapunov fixed point ``P = A P Aᵀ + Q`` by doubling:
    ``ceil(log2 iters)`` squarings."""
    Ak, P = as_tensors(A, Q)
    for _ in range(max(1, math.ceil(math.log2(iters)))):
        P = P + Ak @ P @ Ak.T
        Ak = Ak @ Ak
    return symmetrize(P)


def covar(f, x, u, p=None, t=0.0) -> torch.Tensor:
    """The stationary state covariance of the filter's (linearized)
    dynamics driven by R1."""
    A, _, _, _ = linearize(f, x, u, p, t)
    p = getattr(f, "p", None) if p is None else p
    x, u = as_tensors(x, u, like=A)
    R1 = resolve_mat(f.R1, x, u, p, t, Ts=getattr(f, "Ts", 1.0))
    return dlyap(A, R1)


def kalman_filter_from_ss(A, B, C, D, R1, R2, Ts: float = 1.0, *,
                          device=None, **kwargs):
    """A ``KalmanFilter`` from discrete state-space matrices.  Tensors
    are taken as they are; arrays go to ``device`` (the card unless it
    says otherwise, as ``convert.kalman_filter_from_numpy``)."""
    from ..filters.kalman import KalmanFilter

    mats = (A, B, C, D, R1, R2)
    if all(isinstance(M, torch.Tensor) or M is None or callable(M)
           or (isinstance(M, (int, float)) and M == 0) for M in mats):
        return KalmanFilter(*mats, Ts=Ts, **kwargs)
    from ..convert import kalman_filter_from_numpy

    return kalman_filter_from_numpy(*mats, Ts=Ts,
                                    device=default_device(device), **kwargs)
