"""Decoupled measurement models (counterpart of
``models/measurement_models.py``).

Any Kalman-type filter can correct with any of these models; each
implements

    state, info = model.correct(kf, state, u, y, p, t, R2=None)

over the common Gaussian state ``KFState(x, R, t)``.  Jacobians default
to ``torch.func.jacfwd`` where the JAX package takes ``jax.jacfwd``.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..ops.linalg import blkdiag, chol_lower, rdiv_chol, symmetrize
from ..ops.matrices import MatLike, as_matspec, resolve_mat
from ..ops.mvnormal import mvnormal_logpdf
from ..utils.struct import struct
from .sigmapoints import (TrivialParams, UTParams, sigmapoints, ukf_weights,
                          ut_cov, ut_cross_cov, ut_mean)


class AbstractMeasurementModel:
    """Marker base of the measurement models."""


def _ts(kf) -> float:
    """Sampling time of the owning filter (indexes time-stacked mats)."""
    return getattr(kf, "Ts", 1.0)


def _ny_of(R2, ny: int) -> int:
    if ny < 0 and isinstance(R2, torch.Tensor):
        return R2.shape[-1]
    return ny


def _jacfwd(fn, x, u, p, t):
    return torch.func.jacfwd(lambda xi: fn(xi, u, p, t))(x)


def _gaussian_update(x, R, C, e, R2, R12=None, chol=None):
    """Linearized measurement update shared by the linear and EKF models,
    with the correlated-noise (R12) branch; returns (x, R, info)."""
    from ..filters.kalman import KalmanInfo

    eye = torch.eye(R.shape[-1], dtype=R.dtype, device=R.device)
    if R12 is not None:
        CR12 = C @ R12
        S = symmetrize(C @ R @ C.mT + CR12 + CR12.mT) + R2
        Schol = chol(S) if chol is not None else chol_lower(S)
        K = rdiv_chol(R @ C.mT + R12, Schol)
        xn = x + K @ e
        Rn = symmetrize((eye - K @ C) @ R - K @ R12.mT)
    else:
        S = symmetrize(C @ R @ C.mT) + R2
        Schol = chol(S) if chol is not None else chol_lower(S)
        K = rdiv_chol(R @ C.mT, Schol)
        xn = x + K @ e
        Rn = symmetrize((eye - K @ C) @ R)
    ll = mvnormal_logpdf(e, torch.zeros_like(e), Schol)
    return xn, Rn, KalmanInfo(ll=ll, e=e, S=S, Schol=Schol, K=K)


def _has_input(u) -> bool:
    return u is not None and u.numel() > 0


@struct
class LinearMeasurementModel(AbstractMeasurementModel):
    """``y = Cx + Du + e``."""

    C: MatLike
    D: MatLike = None
    R2: MatLike = None
    R12: MatLike = None
    ny: int = -1

    def __post_init__(self):
        o = object.__setattr__
        o(self, "C", as_matspec(self.C))
        o(self, "R2", as_matspec(self.R2))
        o(self, "R12", as_matspec(self.R12))
        if isinstance(self.D, (int, float)) and self.D == 0:
            o(self, "D", None)
        else:
            o(self, "D", as_matspec(self.D))
        o(self, "ny", _ny_of(self.R2, self.ny))

    def __call__(self, x, u, p, t):
        y = resolve_mat(self.C, x, u, p, t) @ x
        Dt = resolve_mat(self.D, x, u, p, t)
        if Dt is not None and _has_input(u):
            y = y + Dt @ u
        return y

    def correct(self, kf, state, u, y, p=None, t=0, R2=None):
        x, R = state.x, state.R
        Ts = _ts(kf)
        Ct = resolve_mat(self.C, x, u, p, t, Ts=Ts)
        Dt = resolve_mat(self.D, x, u, p, t, Ts=Ts)
        R2 = resolve_mat(self.R2, x, u, p, t, Ts=Ts) if R2 is None else R2
        R12 = resolve_mat(self.R12, x, u, p, t, Ts=Ts)
        e = y - Ct @ x
        if Dt is not None and _has_input(u):
            e = e - Dt @ u
        xn, Rn, info = _gaussian_update(
            x, R, Ct, e, R2, R12=R12, chol=getattr(kf, "cholesky_fn", None))
        return state.replace(x=xn, R=Rn), info


@struct
class EKFMeasurementModel(AbstractMeasurementModel):
    """Nonlinear measurement linearized by forward-mode autodiff; ``Cjac``
    overrides the Jacobian ``(x, u, p, t) -> C``."""

    measurement: Callable
    R2: MatLike = None
    R12: MatLike = None
    Cjac: Optional[Callable] = None
    ny: int = -1

    def __post_init__(self):
        o = object.__setattr__
        o(self, "R2", as_matspec(self.R2))
        o(self, "R12", as_matspec(self.R12))
        o(self, "ny", _ny_of(self.R2, self.ny))

    def __call__(self, x, u, p, t):
        return self.measurement(x, u, p, t)

    def _Cjac(self, x, u, p, t):
        if self.Cjac is not None:
            return self.Cjac(x, u, p, t)
        return _jacfwd(self.measurement, x, u, p, t)

    def correct(self, kf, state, u, y, p=None, t=0, R2=None):
        x, R = state.x, state.R
        C = self._Cjac(x, u, p, t)
        Ts = _ts(kf)
        R2 = resolve_mat(self.R2, x, u, p, t, Ts=Ts) if R2 is None else R2
        R12 = resolve_mat(self.R12, x, u, p, t, Ts=Ts)
        e = y - self.measurement(x, u, p, t)
        xn, Rn, info = _gaussian_update(
            x, R, C, e, R2, R12=R12, chol=getattr(kf, "cholesky_fn", None))
        return state.replace(x=xn, R=Rn), info


@struct
class IEKFMeasurementModel(AbstractMeasurementModel):
    """Iterated (Gauss–Newton) measurement update: ``maxiters`` fixed
    iterations with convergence masking, as in the JAX package (the same
    result as the reference's early exit)."""

    measurement: Callable
    R2: MatLike = None
    R12: MatLike = None
    Cjac: Optional[Callable] = None
    ny: int = -1
    step: float = 1.0
    maxiters: int = 10
    epsilon: float = 1e-8

    def __post_init__(self):
        o = object.__setattr__
        o(self, "R2", as_matspec(self.R2))
        o(self, "R12", as_matspec(self.R12))
        o(self, "ny", _ny_of(self.R2, self.ny))
        if not (0 < self.step <= 1):
            raise ValueError("IEKF step size should be between 0 and 1")

    def __call__(self, x, u, p, t):
        return self.measurement(x, u, p, t)

    def _Cjac(self, x, u, p, t):
        if self.Cjac is not None:
            return self.Cjac(x, u, p, t)
        return _jacfwd(self.measurement, x, u, p, t)

    def correct(self, kf, state, u, y, p=None, t=0, R2=None):
        from ..filters.kalman import KalmanInfo

        x, R = state.x, state.R
        Ts = _ts(kf)
        R2 = resolve_mat(self.R2, x, u, p, t, Ts=Ts) if R2 is None else R2
        R12 = resolve_mat(self.R12, x, u, p, t, Ts=Ts)
        pred_err = y - self.measurement(x, u, p, t)
        eye = torch.eye(x.shape[-1], dtype=R.dtype, device=R.device)

        C = self._Cjac(x, u, p, t)
        S = symmetrize(C @ R @ C.mT) + R2
        Schol = chol_lower(S)
        K = rdiv_chol(R @ C.mT, Schol)
        xi = x
        done = torch.zeros((), dtype=torch.bool, device=x.device)
        for _ in range(self.maxiters):
            Ci = self._Cjac(xi, u, p, t)
            ei = y - self.measurement(xi, u, p, t)
            if R12 is not None:
                CR12 = Ci @ R12
                Si = symmetrize(Ci @ R @ Ci.mT + CR12 + CR12.mT) + R2
                Scholi = chol_lower(Si)
                Ki = rdiv_chol(R @ Ci.mT + R12, Scholi)
            else:
                Si = symmetrize(Ci @ R @ Ci.mT) + R2
                Scholi = chol_lower(Si)
                Ki = rdiv_chol(R @ Ci.mT, Scholi)
            dx = x - xi
            xi_new = xi + self.step * (dx + Ki @ (ei - Ci @ dx))
            newly_done = (xi_new - xi).abs().sum() < self.epsilon
            xi = torch.where(done, xi, xi_new)
            C, S, Schol, K = (torch.where(done, a, b) for a, b in (
                (C, Ci), (S, Si), (Schol, Scholi), (K, Ki)))
            done = done | newly_done
        if R12 is not None:
            Rn = symmetrize((eye - K @ C) @ R - K @ R12.mT)
        else:
            Rn = symmetrize((eye - K @ C) @ R)
        ll = mvnormal_logpdf(pred_err, torch.zeros_like(pred_err), Schol)
        info = KalmanInfo(ll=ll, e=pred_err, S=S, Schol=Schol, K=K)
        return state.replace(x=xi, R=Rn), info


@struct
class UKFMeasurementModel(AbstractMeasurementModel):
    """Sigma-point measurement update.

    - ``augmented=False``: additive noise ``y = h(x,u,p,t) + e``
    - ``augmented=True``: ``y = h(x,u,p,t,e)`` with sigma points drawn
      over the augmented ``[x; e]`` (``ne`` noise dims)
    - ``innovation``/``mean``/``cov``/``cross_cov`` override the UT
      reductions for manifold-valued measurements.
    """

    measurement: Callable
    R2: MatLike = None
    ny: int = -1
    ne: int = 0
    augmented: bool = False
    innovation: Optional[Callable] = None
    mean: Optional[Callable] = None
    cov: Optional[Callable] = None
    cross_cov: Optional[Callable] = None
    weight_params: UTParams = TrivialParams()

    def __post_init__(self):
        o = object.__setattr__
        o(self, "R2", as_matspec(self.R2))
        o(self, "ny", _ny_of(self.R2, self.ny))
        if self.augmented and self.ne == 0:
            if isinstance(self.R2, torch.Tensor):
                o(self, "ne", self.R2.shape[-1])
            else:
                raise ValueError("ne cannot be inferred from R2 when R2 is "
                                 "not a tensor; provide ne explicitly")

    def __call__(self, x, u, p, t):
        if self.augmented:
            return self.measurement(x, u, p, t, x.new_zeros(self.ne))
        return self.measurement(x, u, p, t)

    def correct(self, kf, state, u, y, p=None, t=0, R2=None):
        from ..filters.kalman import KalmanInfo

        x, R = state.x, state.R
        R2 = resolve_mat(self.R2, x, u, p, t, Ts=_ts(kf)) if R2 is None \
            else R2
        nx = x.shape[-1]
        wp = self.weight_params
        chol_fn = getattr(kf, "cholesky_fn", None)
        mean_fn = self.mean or ut_mean
        cov_fn = self.cov or ut_cov
        ccov_fn = self.cross_cov or ut_cross_cov
        innov = self.innovation or (lambda y_, yh: y_ - yh)
        g = self.measurement
        vm = torch.func.vmap

        if self.augmented:
            L = nx + self.ne
            m_aug = torch.cat([x, x.new_zeros(self.ne)])
            xs = sigmapoints(m_aug, blkdiag(R, R2), wp, chol=chol_fn)
            ys = vm(lambda s: g(s[:nx], u, p, t, s[nx:]))(xs)
        else:
            L = nx
            xs = sigmapoints(x, R, wp, chol=chol_fn)
            ys = vm(lambda s: g(s, u, p, t))(xs)

        W = ukf_weights(wp, L)
        ym = mean_fn(ys, W)
        C = ccov_fn(xs[:, :nx], x, ys, ym, W)
        e = innov(y, ym)
        S = symmetrize(cov_fn(ys, ym, W))
        if not self.augmented:
            S = S + R2
        Schol = chol_fn(S) if chol_fn is not None else chol_lower(S)
        K = rdiv_chol(C, Schol)
        xn = x + K @ e
        Rn = symmetrize(R - K @ S @ K.mT)
        ll = mvnormal_logpdf(e, torch.zeros_like(e), Schol)
        info = KalmanInfo(ll=ll, e=e, S=S, Schol=Schol, K=K)
        return state.replace(x=xn, R=Rn), info


@struct
class CompositeMeasurementModel(AbstractMeasurementModel):
    """Sequential multi-sensor update: each component model in turn;
    returns the summed ll, the concatenated innovation and per-model
    (S, Schol, K) tuples."""

    models: tuple

    @property
    def ny(self) -> int:
        return sum(m.ny for m in self.models)

    def __call__(self, x, u, p, t):
        return torch.cat([m(x, u, p, t) for m in self.models])

    def correct(self, kf, state, u, y, p=None, t=0, R2=None):
        from ..filters.kalman import KalmanInfo

        ll = 0.0
        es, Ss, Schols, Ks = [], [], [], []
        i = 0
        for m in self.models:
            yi = y[i:i + m.ny]
            i += m.ny
            state, info = m.correct(kf, state, u, yi, p, t)
            ll = ll + info.ll
            es.append(info.e)
            Ss.append(info.S)
            Schols.append(info.Schol)
            Ks.append(info.K)
        info = KalmanInfo(ll=ll, e=torch.cat(es), S=tuple(Ss),
                          Schol=tuple(Schols), K=tuple(Ks))
        return state, info

