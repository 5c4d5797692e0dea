"""Linear Kalman filter (counterpart of ``filters/kalman.py``).

Same predict/correct algebra as the JAX package (α-forgetting, the R12
cross-covariance branch, the D feedthrough).  ``loglik_fused`` and
``forward_trajectory_fused`` delegate to an EKF with constant Jacobians,
which the whole-scan kernel H runs (kernels/ukf_scan.py).
"""
from __future__ import annotations

import warnings
from typing import Any

import torch

from ..ops.linalg import symmetrize, chol_lower, rdiv_chol
from ..ops.matrices import (IndexingMatrix, MatLike, as_matspec,
                            resolve_mat)
from ..ops.mvnormal import MvNormal, as_mvnormal, mvnormal_logpdf
from ..utils.signal_names import SignalNames, default_names
from ..utils.struct import struct
from .base import AbstractKalmanFilter


@struct
class KFState:
    """Gaussian filter state: mean ``x``, covariance ``R``, step ``t``."""

    x: torch.Tensor
    R: torch.Tensor
    t: int = 0


@struct
class KalmanInfo:
    """Per-step correction outputs ``(ll, e, S, Schol, K)``."""

    ll: torch.Tensor
    e: torch.Tensor
    S: torch.Tensor
    Schol: torch.Tensor
    K: torch.Tensor


def _has_input(u) -> bool:
    return u is not None and u.numel() > 0


def _add_input(x, Bt, u):
    if Bt is None or not _has_input(u):
        return x
    return x + Bt @ u


def kf_predict(x, R, At, Bt, u, R1, alpha=1.0):
    """x⁺ = A x + B u;  R⁺ = α·sym(A R Aᵀ) + R1."""
    x = _add_input(At @ x, Bt, u)
    R = alpha * symmetrize(At @ R @ At.T) + R1
    return x, R


def kf_correct(x, R, Ct, Dt, u, y, R2, R12=None):
    """Linear measurement update; returns ``(x, R, KalmanInfo)``.  The
    correlated-noise branch (``R12``) is Simon's Eq. 7.14."""
    e = y - Ct @ x
    if Dt is not None and _has_input(u):
        e = e - Dt @ u
    eye = torch.eye(R.shape[-1], dtype=R.dtype, device=R.device)
    if R12 is not None:
        CR12 = Ct @ R12
        S = symmetrize(Ct @ R @ Ct.T + CR12 + CR12.T) + R2
        Schol = chol_lower(S)
        K = rdiv_chol(R @ Ct.T + R12, Schol)
        x = x + K @ e
        R = symmetrize((eye - K @ Ct) @ R - K @ R12.T)
    else:
        S = symmetrize(Ct @ R @ Ct.T) + R2
        Schol = chol_lower(S)
        K = rdiv_chol(R @ Ct.T, Schol)
        x = x + K @ e
        R = symmetrize((eye - K @ Ct) @ R)
    ll = mvnormal_logpdf(e, torch.zeros_like(e), Schol)
    return x, R, KalmanInfo(ll=ll, e=e, S=S, Schol=Schol, K=K)


@struct
class KalmanFilter(AbstractKalmanFilter):
    """Linear-Gaussian filter for ``x⁺ = Ax + Bu + w``, ``y = Cx + Du + e``.

    Every system matrix is a constant tensor, a ``[T, ...]`` time-stacked
    tensor, a callable ``(x, u, p, t) -> M`` or, for ``C``, an
    :class:`IndexingMatrix` (ops/matrices.py).  ``alpha`` is the
    exponential-forgetting factor.
    """

    A: MatLike
    B: MatLike
    C: MatLike
    D: MatLike = None
    R1: MatLike = None
    R2: MatLike = None
    R12: MatLike = None
    d0: MvNormal = None
    p: Any = None
    alpha: Any = 1.0
    Ts: float = 1.0
    nx: int = -1
    nu: int = -1
    ny: int = -1
    names: SignalNames = None
    check: bool = True

    def __post_init__(self):
        o = object.__setattr__
        for name in ("A", "B", "C", "R1", "R2", "R12"):
            o(self, name, as_matspec(getattr(self, name)))
        if self.check:
            _check_constructor_sanity(self.A, self.alpha)
        nx, nu, ny = self.nx, self.nu, self.ny
        if nx < 0 and isinstance(self.A, torch.Tensor) and self.A.ndim == 2:
            nx = self.A.shape[-1]
        if nu < 0 and isinstance(self.B, torch.Tensor):
            nu = self.B.shape[-1] if self.B.ndim >= 2 else 1
        if ny < 0 and isinstance(self.C, torch.Tensor) and self.C.ndim == 2:
            ny = self.C.shape[-2]
        if ny < 0 and isinstance(self.C, IndexingMatrix):
            ny = self.C.shape[0]
        if nx < 0 and self.d0 is not None and hasattr(self.d0, "mean"):
            nx = self.d0.mean.shape[-1]
        o(self, "nx", nx)
        o(self, "nu", nu)
        o(self, "ny", ny)
        if self.d0 is None:
            if not isinstance(self.R1, torch.Tensor) or self.R1.ndim != 2:
                raise ValueError("d0 must be provided explicitly when R1 is "
                                 "not a constant matrix")
            o(self, "d0", as_mvnormal(self.R1))
        else:
            o(self, "d0", as_mvnormal(self.d0))
        # D == 0 / None means no feedthrough
        if isinstance(self.D, (int, float)) and self.D == 0:
            o(self, "D", None)
        else:
            o(self, "D", as_matspec(self.D))
        if self.names is None:
            o(self, "names", default_names(max(nx, 0), max(nu, 0),
                                           max(ny, 0), "KF"))

    def init(self, generator=None) -> KFState:
        return KFState(x=self.d0.mean, R=self.d0.cov, t=0)

    def predict(self, state: KFState, u=None, p=None, t=None, R1=None,
                alpha=None) -> KFState:
        p = self.p if p is None else p
        t = state.t * self.Ts if t is None else t
        At = resolve_mat(self.A, state.x, u, p, t, Ts=self.Ts)
        Bt = resolve_mat(self.B, state.x, u, p, t, Ts=self.Ts)
        if R1 is None:
            R1 = resolve_mat(self.R1, state.x, u, p, t, Ts=self.Ts)
        a = self.alpha if alpha is None else alpha
        x, R = kf_predict(state.x, state.R, At, Bt, u, R1, a)
        return KFState(x=x, R=R, t=state.t + 1)

    def correct(self, state: KFState, u, y, p=None, t=None, R2=None,
                mm=None):
        """Measurement update; ``mm`` (a measurement model) takes the place
        of the filter's own C, D, R2."""
        p = self.p if p is None else p
        t = state.t * self.Ts if t is None else t
        if mm is not None:
            return mm.correct(self, state, u, y, p, t)
        Ct = resolve_mat(self.C, state.x, u, p, t, Ts=self.Ts)
        Dt = resolve_mat(self.D, state.x, u, p, t, Ts=self.Ts)
        if R2 is None:
            R2 = resolve_mat(self.R2, state.x, u, p, t, Ts=self.Ts)
        R12 = resolve_mat(self.R12, state.x, u, p, t, Ts=self.Ts)
        x, R, info = kf_correct(state.x, state.R, Ct, Dt, u, y, R2, R12)
        return KFState(x=x, R=R, t=state.t), info

    def _fused_delegate(self):
        """An EKF with the constant system matrices as callbacks and
        constant Jacobians, for the whole-scan kernels; None when out of
        scope (time-stacked matrices, R12, a non-scalar alpha)."""
        from .ekf import make_ekf

        const = all(M is None or isinstance(M, torch.Tensor) and M.ndim <= 2
                    for M in (self.A, self.B, self.C, self.D, self.R1,
                              self.R2))
        if not const or self.R12 is not None or not isinstance(
                self.alpha, (int, float)):
            return None
        A, B, C, D = self.A, self.B, self.C, self.D

        def dyn(x, u, p, t):
            xn = A @ x
            if B is not None and u is not None and u.shape[-1]:
                xn = xn + B @ u
            return xn

        def meas(x, u, p, t):
            y = C @ x
            if D is not None and u is not None and u.shape[-1]:
                y = y + D @ u
            return y

        return make_ekf(dyn, meas, self.R1, self.R2, d0=self.d0,
                        nu=max(self.nu, 0), ny=self.ny, Ts=self.Ts,
                        alpha=self.alpha, Ajac=lambda x, u, p, t: A,
                        Cjac=lambda x, u, p, t: C)

    def loglik_fused(self, ys, us=None):
        """Whole-trajectory log-likelihood through the delegated EKF's
        whole-scan kernel (kernel H: its Jacobians are constant); the
        sequential recursion when the delegation is out of scope.  The
        delegate and its admission are kept per filter."""
        from ..kernels.ukf_scan import ekf_loglik_fused

        return ekf_loglik_fused(self, ys, us)

    def forward_trajectory_fused(self, us, ys):
        """Full :class:`KalmanFilteringSolution` through the same
        delegation."""
        from ..kernels.ukf_scan import ekf_forward_trajectory_fused

        return ekf_forward_trajectory_fused(self, us, ys)

    def measurement_fn(self):
        """Out-of-place measurement function ``g(x, u, p, t)``."""

        def g(x, u, p, t):
            y = resolve_mat(self.C, x, u, p, t, Ts=self.Ts) @ x
            Dt = resolve_mat(self.D, x, u, p, t, Ts=self.Ts)
            if Dt is not None and _has_input(u):
                y = y + Dt @ u
            return y

        return g

    def dynamics_fn(self):
        """Out-of-place dynamics function ``f(x, u, p, t)``."""

        def f(x, u, p, t):
            xn = resolve_mat(self.A, x, u, p, t, Ts=self.Ts) @ x
            return _add_input(xn, resolve_mat(self.B, x, u, p, t,
                                              Ts=self.Ts), u)

        return f

    def sample_initial(self, generator, p=None, noise=True):
        return self.d0.sample(generator) if noise else self.d0.mean

    def sample_state(self, generator, x, u, p=None, t=0, noise=True):
        xn = self.dynamics_fn()(x, u, p, t)
        if noise:
            R1 = resolve_mat(self.R1, x, u, p, t, Ts=self.Ts)
            xn = xn + as_mvnormal(R1).sample(generator)
        return xn

    def sample_measurement(self, generator, x, u, p=None, t=0, noise=True):
        y = self.measurement_fn()(x, u, p, t)
        if noise:
            R2 = resolve_mat(self.R2, x, u, p, t, Ts=self.Ts)
            y = y + as_mvnormal(R2).sample(generator)
        return y


def _check_constructor_sanity(A, alpha) -> None:
    """Warn on α < 1 and on a dynamics matrix with |eig| >= 2.  Skipped
    for tensors under a ``torch.func`` transform (a member rebuilt inside
    ``vmap``), whose values cannot be read, as the JAX package skips it
    for traced values."""
    from ..routing import _under_batch_trace

    if _under_batch_trace(A):
        return
    if isinstance(alpha, (int, float)) and alpha < 1.0:
        warnings.warn("alpha should be >= 1 for exponential forgetting; "
                      "alpha < 1 leads to exponential loss of adaptation "
                      "over time", stacklevel=3)
    if isinstance(A, torch.Tensor) and A.ndim == 2 \
            and A.shape[0] == A.shape[1]:
        ev = torch.linalg.eigvals(A.detach().cpu().double()).abs().max()
        if float(ev) >= 2.0:
            warnings.warn(
                "The dynamics matrix A has eigenvalues with absolute value "
                f">= 2 (max {float(ev):.3g}). This is either a highly "
                "unstable system, or you have forgotten to discretize a "
                "continuous-time model. Disable this check with "
                "check=False.", stacklevel=3)
