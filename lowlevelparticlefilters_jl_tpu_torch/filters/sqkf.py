"""Square-root Kalman filters, linear and extended (counterpart of
``filters/sqkf.py``).

The state covariance is kept as its upper-triangular Cholesky factor
``U`` (Σ = UᵀU); the time and measurement updates are thin QR
factorizations whose R factor is taken with a positive diagonal
(``ops/linalg.positive_qr_r``), so the factors agree with the JAX
package's whatever sign convention each QR routine follows.  As in the
JAX package, ``covariance`` and the solutions' R/Rt materialize the full
``UᵀU``; the factors travel in ``state.U`` and ``sol.extra``.

These filters have no kernel: every verb runs the sequential
recursion, and ``smooth`` reaches the factored RTS smoother here
(``routing.route_smooth`` admits only the plain KF, UKF and EKF).
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from ..models.measurement_models import EKFMeasurementModel
from ..ops.linalg import positive_qr_r
from ..ops.matrices import MatLike, as_matspec, resolve_mat
from ..ops.mvnormal import MvNormal, as_mvnormal, mvnormal_logpdf
from ..utils.signal_names import SignalNames, default_names
from ..utils.struct import struct
from .base import AbstractKalmanFilter
from .kalman import KalmanInfo, _add_input, _has_input


@struct
class SqKFState:
    """Square-root filter state: mean ``x``, upper Cholesky factor ``U``."""

    x: torch.Tensor
    U: torch.Tensor
    t: int = 0


def _upper_factor(R):
    """A covariance matrix's upper Cholesky factor (Σ = UᵀU)."""
    if R is None:
        return None
    return torch.linalg.cholesky_ex(torch.as_tensor(R))[0].mT


def _solve_tri(M, B, *, lower: bool):
    return torch.linalg.solve_triangular(M, B, upper=not lower)


def sqkf_predict_factor(U, At, U1, alpha=1.0):
    """U⁺ = qr([√α U Aᵀ; U1]).R."""
    a = alpha ** 0.5 if isinstance(alpha, (int, float)) else torch.sqrt(
        torch.as_tensor(alpha, dtype=U.dtype))
    return positive_qr_r(torch.cat([a * U @ At.mT, U1], 0))


def sqkf_correct_factor(x, U, Ct, e, U2):
    """Square-root measurement update; returns ``(x, U, info)`` with the
    full innovation covariance ``S`` and its lower factor ``Schol`` in
    the info."""
    S0 = positive_qr_r(torch.cat([U @ Ct.mT, U2], 0))     # upper, +diag
    B = U.mT @ (U @ Ct.mT)
    # K = ((Uᵀ (U Cᵀ)) / S) / Sᵀ: two triangular solves
    tmp = _solve_tri(S0.mT, B.mT, lower=True)
    K = _solve_tri(S0, tmp, lower=False).mT
    xn = x + K @ e
    eye = torch.eye(U.shape[-1], dtype=U.dtype, device=U.device)
    Un = positive_qr_r(torch.cat([U @ (eye - K @ Ct).mT, U2 @ K.mT], 0))
    ll = mvnormal_logpdf(e, torch.zeros_like(e), S0.mT)
    return xn, Un, KalmanInfo(ll=ll, e=e, S=S0.mT @ S0, Schol=S0.mT, K=K)


def sqkf_correct_mm(flt, state, u, y, p, t, mm, R2=None):
    """Measurement-model dispatch of the square-root filters: a linear or
    EKF model without R12 stays on the QR path (an explicit ``R2`` is an
    upper factor there); any other model corrects the full covariance
    ``UᵀU`` and the result is factored again."""
    from ..models.measurement_models import LinearMeasurementModel
    from .kalman import KFState

    Ts = getattr(flt, "Ts", 1.0)
    x = state.x
    if isinstance(mm, LinearMeasurementModel) and mm.R12 is None:
        Ct = resolve_mat(mm.C, x, u, p, t, Ts=Ts)
        Dt = resolve_mat(mm.D, x, u, p, t, Ts=Ts)
        U2 = _upper_factor(resolve_mat(mm.R2, x, u, p, t, Ts=Ts)) \
            if R2 is None else R2
        e = y - Ct @ x
        if Dt is not None and _has_input(u):
            e = e - Dt @ u
        xn, Un, info = sqkf_correct_factor(x, state.U, Ct, e, U2)
        return SqKFState(x=xn, U=Un, t=state.t), info
    if type(mm) is EKFMeasurementModel and mm.R12 is None:
        C = mm._Cjac(x, u, p, t)
        U2 = _upper_factor(resolve_mat(mm.R2, x, u, p, t, Ts=Ts)) \
            if R2 is None else R2
        e = y - mm.measurement(x, u, p, t)
        xn, Un, info = sqkf_correct_factor(x, state.U, C, e, U2)
        return SqKFState(x=xn, U=Un, t=state.t), info
    R2_full = None if R2 is None else R2.mT @ R2
    kstate = KFState(x=x, R=state.U.mT @ state.U, t=state.t)
    kstate, info = mm.correct(flt, kstate, u, y, p, t, R2=R2_full)
    return SqKFState(x=kstate.x, U=_upper_factor(kstate.R), t=state.t), info


def _sq_forward_factors(flt, u, y, p):
    """The forward pass keeping each step's predicted and filtered factors:
    ``(u_seq, tvec, (x, U, xt, Ut, ll, e, S, K))``, stacked."""
    from ..trajectory import _as_u_seq

    T = y.shape[0]
    u_seq = _as_u_seq(u, T, y.dtype, y.device)
    tvec = torch.arange(T, dtype=y.dtype, device=y.device) * flt.Ts
    state = flt.init()
    rows = []
    for k in range(T):
        tk = k * flt.Ts
        xp, Up = state.x, state.U
        state, info = flt.correct(state, u_seq[k], y[k], p, tk)
        xf, Uf = state.x, state.U
        state = flt.predict(state, u_seq[k], p, tk)
        rows.append((xp, Up, xf, Uf, info.ll, info.e, info.S, info.K))
    return u_seq, tvec, tuple(torch.stack(c) for c in zip(*rows))


def sqkf_rts_backward(x, U, xt, Ut, A_fn, U1_fn, u_seq, tvec, alpha=1.0,
                      lin_at_next=True):
    """The square-root RTS backward pass on Cholesky factors end to end:

        RT_t = (I − C A) Rt_t (I − C A)ᵀ + C Q̂ Cᵀ + C RT_{t+1} Cᵀ,
        Q̂ = R1 + (α − 1) A Rt_t Aᵀ,

    one thin QR of stacked factor blocks a step; the smoother gain C by
    two triangular solves against the stored predicted factor U_{t+1}.
    ``A_fn(x_lin, u, t)`` gives the transition (at the next step's
    smoothed point and input when ``lin_at_next``, the SqEKF's
    re-linearization; else at step t's input), ``U1_fn(x, u, t)`` the
    process noise's upper factor."""
    nx = x.shape[-1]
    eye = torch.eye(nx, dtype=x.dtype, device=x.device)
    a_extra = max(float(alpha) - 1.0, 0.0) ** 0.5
    T = x.shape[0]
    tl = tvec.tolist()       # the step times as floats, read once
    xT_next, UT_next = xt[-1], Ut[-1]
    xTs, UTs = [xT_next], [UT_next]
    for k in range(T - 2, -1, -1):
        A = (A_fn(xT_next, u_seq[k + 1], tl[k + 1]) if lin_at_next
             else A_fn(xT_next, u_seq[k], tl[k]))
        UtAT = Ut[k] @ A.mT
        RtAT = Ut[k].mT @ UtAT
        Z = _solve_tri(U[k + 1].mT, RtAT.mT, lower=True)
        C = _solve_tri(U[k + 1], Z, lower=False).mT
        xT_next = xt[k] + C @ (xT_next - x[k + 1])
        U1k = U1_fn(xt[k], u_seq[k], tl[k])
        UT_next = positive_qr_r(torch.cat(
            [Ut[k] @ (eye - C @ A).mT, U1k @ C.mT, UT_next @ C.mT,
             a_extra * (UtAT @ C.mT)], 0))
        xTs.append(xT_next)
        UTs.append(UT_next)
    return torch.stack(xTs[::-1]), torch.stack(UTs[::-1])


def _sq_smooth(flt, u, y, p, A_fn, lin_at_next=True):
    """Forward factors, the factored RTS pass, and the solutions with full
    covariances (the factors in ``sol.extra``)."""
    from ..utils.solutions import (KalmanFilteringSolution,
                                   KalmanSmoothingSolution)

    u_seq, tvec, (x, U, xt, Ut, lls, e, S, K) = _sq_forward_factors(
        flt, u, y, p)

    def U1_fn(xk, uk, tk):
        return resolve_mat(flt.R1, xk, uk, p, tk, Ts=flt.Ts)

    xT, UT = sqkf_rts_backward(x, U, xt, Ut, A_fn, U1_fn, u_seq, tvec,
                               alpha=flt.alpha, lin_at_next=lin_at_next)

    def cov(F):
        return F.mT @ F

    ok = torch.isfinite(xt).all(-1) & torch.isfinite(e).all(-1)
    sol = KalmanFilteringSolution(
        u=u_seq, y=y, x=x, xt=xt, R=cov(U), Rt=cov(Ut), ll=lls.sum(), e=e,
        K=K, S=S, extra={"U": U, "Ut": Ut, "UT": UT}, t=tvec, ok=ok,
        route="sequential")
    return KalmanSmoothingSolution(sol=sol, xT=xT, RT=cov(UT))


def _factor_noise(flt, name):
    """Store a constant covariance as its upper factor, once; a callable
    returns upper factors already."""
    M = getattr(flt, name)
    object.__setattr__(flt, name, as_matspec(M) if callable(M)
                       else _upper_factor(M))


@struct
class SqKalmanFilter(AbstractKalmanFilter):
    """Linear Kalman filter in square-root form.

    ``R1``/``R2`` are covariance matrices (factored at construction) or
    callables returning **upper Cholesky factors**, the reference's
    convention for function-valued noise."""

    A: MatLike
    B: MatLike
    C: MatLike
    D: MatLike = None
    R1: MatLike = None
    R2: MatLike = None
    d0: MvNormal = None
    p: Any = None
    alpha: Any = 1.0
    Ts: float = 1.0
    nx: int = -1
    nu: int = -1
    ny: int = -1
    names: SignalNames = None
    _factored: bool = False

    def __post_init__(self):
        o = object.__setattr__
        for name in ("A", "B", "C"):
            o(self, name, as_matspec(getattr(self, name)))
        if isinstance(self.D, (int, float)) and self.D == 0:
            o(self, "D", None)
        else:
            o(self, "D", as_matspec(self.D))
        if not self._factored:
            if self.d0 is None:
                if callable(self.R1):
                    raise ValueError("d0 must be provided when R1 is not a "
                                     "matrix")
                o(self, "d0", as_mvnormal(torch.as_tensor(self.R1)))
            else:
                o(self, "d0", as_mvnormal(self.d0))
            _factor_noise(self, "R1")
            _factor_noise(self, "R2")
            o(self, "_factored", True)
        nx, nu, ny = self.nx, self.nu, self.ny
        if nx < 0:
            nx = self.d0.dim
        if nu < 0 and isinstance(self.B, torch.Tensor):
            nu = self.B.shape[-1]
        if ny < 0 and isinstance(self.C, torch.Tensor):
            ny = self.C.shape[-2]
        o(self, "nx", nx)
        o(self, "nu", nu)
        o(self, "ny", ny)
        if self.names is None:
            o(self, "names", default_names(nx, max(nu, 0), max(ny, 0),
                                           "SqKF"))

    def covariance(self, state):
        return state.U.mT @ state.U

    def init(self, generator=None) -> SqKFState:
        return SqKFState(x=self.d0.mean, U=_upper_factor(self.d0.cov), t=0)

    def predict(self, state: SqKFState, u=None, p=None, t=None, R1=None,
                alpha=None) -> SqKFState:
        p = self.p if p is None else p
        t = state.t * self.Ts if t is None else t
        At = resolve_mat(self.A, state.x, u, p, t, Ts=self.Ts)
        Bt = resolve_mat(self.B, state.x, u, p, t, Ts=self.Ts)
        U1 = resolve_mat(self.R1, state.x, u, p, t, Ts=self.Ts) \
            if R1 is None else R1
        a = self.alpha if alpha is None else alpha
        x = _add_input(At @ state.x, Bt, u)
        return SqKFState(x=x, U=sqkf_predict_factor(state.U, At, U1, a),
                         t=state.t + 1)

    def correct(self, state: SqKFState, u, y, p=None, t=None, R2=None,
                mm=None):
        """Square-root measurement update; an explicit ``R2`` is an upper
        factor; ``mm`` dispatches as :func:`sqkf_correct_mm`."""
        p = self.p if p is None else p
        t = state.t * self.Ts if t is None else t
        if mm is not None:
            return sqkf_correct_mm(self, state, u, y, p, t, mm, R2=R2)
        Ct = resolve_mat(self.C, state.x, u, p, t, Ts=self.Ts)
        Dt = resolve_mat(self.D, state.x, u, p, t, Ts=self.Ts)
        U2 = resolve_mat(self.R2, state.x, u, p, t, Ts=self.Ts) \
            if R2 is None else R2
        e = y - Ct @ state.x
        if Dt is not None and _has_input(u):
            e = e - Dt @ u
        x, U, info = sqkf_correct_factor(state.x, state.U, Ct, e, U2)
        return SqKFState(x=x, U=U, t=state.t), info

    def smooth(self, u, y, p=None, **kwargs):
        """The factored RTS smoother (:func:`sqkf_rts_backward`), the
        transition taken at step t, where the predict used it."""
        p = self.p if p is None else p

        def A_fn(x_lin, uk, tk):
            return resolve_mat(self.A, x_lin, uk, p, tk, Ts=self.Ts)

        return _sq_smooth(self, u, y, p, A_fn, lin_at_next=False)

    def sample_initial(self, generator, p=None, noise=True):
        return self.d0.sample(generator) if noise else self.d0.mean

    def sample_state(self, generator, x, u, p=None, t=0, noise=True):
        At = resolve_mat(self.A, x, u, p, t, Ts=self.Ts)
        xn = _add_input(At @ x, resolve_mat(self.B, x, u, p, t, Ts=self.Ts),
                        u)
        if noise:
            U1 = resolve_mat(self.R1, x, u, p, t, Ts=self.Ts)
            xn = xn + U1.mT @ torch.randn(self.nx, generator=generator,
                                          dtype=xn.dtype, device=xn.device)
        return xn

    def sample_measurement(self, generator, x, u, p=None, t=0, noise=True):
        yy = resolve_mat(self.C, x, u, p, t, Ts=self.Ts) @ x
        Dt = resolve_mat(self.D, x, u, p, t, Ts=self.Ts)
        if Dt is not None and _has_input(u):
            yy = yy + Dt @ u
        if noise:
            U2 = resolve_mat(self.R2, x, u, p, t, Ts=self.Ts)
            yy = yy + U2.mT @ torch.randn(self.ny, generator=generator,
                                          dtype=yy.dtype, device=yy.device)
        return yy


@struct
class SqExtendedKalmanFilter(AbstractKalmanFilter):
    """Square-root EKF: linearized dynamics and measurement with QR
    factor updates; Jacobians by ``torch.func.jacfwd`` unless ``Ajac`` (or
    the measurement model's ``Cjac``) is given."""

    dynamics: Callable
    measurement_model: Any
    R1: MatLike = None
    d0: MvNormal = None
    p: Any = None
    alpha: Any = 1.0
    Ajac: Optional[Callable] = None
    Ts: float = 1.0
    nu: int = -1
    ny: int = -1
    names: SignalNames = None
    _factored: bool = False

    def __post_init__(self):
        o = object.__setattr__
        if not self._factored:
            o(self, "d0", as_mvnormal(torch.as_tensor(self.R1))
              if self.d0 is None else as_mvnormal(self.d0))
            _factor_noise(self, "R1")
            o(self, "_factored", True)
        ny = self.ny if self.ny >= 0 else getattr(self.measurement_model,
                                                  "ny", -1)
        o(self, "ny", ny)
        if self.names is None:
            o(self, "names", default_names(self.d0.dim, max(self.nu, 0),
                                           max(ny, 0), "SqEKF"))

    @property
    def nx(self) -> int:
        return self.d0.dim

    def _Ajac(self, x, u, p, t):
        if self.Ajac is not None:
            return self.Ajac(x, u, p, t)
        return torch.func.jacfwd(lambda xi: self.dynamics(xi, u, p, t))(x)

    def covariance(self, state):
        return state.U.mT @ state.U

    def init(self, generator=None) -> SqKFState:
        return SqKFState(x=self.d0.mean, U=_upper_factor(self.d0.cov), t=0)

    def predict(self, state: SqKFState, u=None, p=None, t=None, R1=None,
                alpha=None) -> SqKFState:
        p = self.p if p is None else p
        t = state.t * self.Ts if t is None else t
        A = self._Ajac(state.x, u, p, t)
        U1 = resolve_mat(self.R1, state.x, u, p, t, Ts=self.Ts) \
            if R1 is None else R1
        a = self.alpha if alpha is None else alpha
        return SqKFState(x=self.dynamics(state.x, u, p, t),
                         U=sqkf_predict_factor(state.U, A, U1, a),
                         t=state.t + 1)

    def correct(self, state: SqKFState, u, y, p=None, t=None, R2=None,
                mm=None):
        """Every model through :func:`sqkf_correct_mm`; an explicit ``R2``
        is an upper factor."""
        p = self.p if p is None else p
        t = state.t * self.Ts if t is None else t
        model = self.measurement_model if mm is None else mm
        return sqkf_correct_mm(self, state, u, y, p, t, model, R2=R2)

    def smooth(self, u, y, p=None, **kwargs):
        """The factored RTS smoother, re-linearizing A at the next step's
        smoothed point as the reference does."""
        p = self.p if p is None else p

        def A_fn(x_lin, uk, tk):
            return self._Ajac(x_lin, uk, p, tk)

        return _sq_smooth(self, u, y, p, A_fn, lin_at_next=True)

    def sample_initial(self, generator, p=None, noise=True):
        return self.d0.sample(generator) if noise else self.d0.mean

    def sample_state(self, generator, x, u, p=None, t=0, noise=True):
        xn = self.dynamics(x, u, p, t)
        if noise:
            U1 = resolve_mat(self.R1, x, u, p, t, Ts=self.Ts)
            xn = xn + U1.mT @ torch.randn(x.shape, generator=generator,
                                          dtype=xn.dtype, device=xn.device)
        return xn

    def sample_measurement(self, generator, x, u, p=None, t=0, noise=True):
        mm = self.measurement_model
        yy = mm.measurement(x, u, p, t)
        if noise:
            R2 = resolve_mat(mm.R2, x, u, p, t, Ts=self.Ts)
            yy = yy + as_mvnormal(R2).sample(generator)
        return yy


def make_sqekf(dynamics, measurement, R1, R2, d0=None, *, Cjac=None,
               **kwargs) -> SqExtendedKalmanFilter:
    """Convenience constructor: the EKF measurement model from a
    measurement function and R2 (a covariance)."""
    mm = EKFMeasurementModel(measurement=measurement, R2=as_matspec(R2),
                             Cjac=Cjac)
    return SqExtendedKalmanFilter(dynamics=dynamics, measurement_model=mm,
                                  R1=R1, d0=d0, **kwargs)
