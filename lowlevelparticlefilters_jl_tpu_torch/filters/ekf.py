"""Extended Kalman filter and the iterated variant's constructor
(counterpart of ``filters/ekf.py``).

Jacobians default to ``torch.func.jacfwd`` of the callbacks in x.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from ..models.measurement_models import (AbstractMeasurementModel,
                                         EKFMeasurementModel,
                                         IEKFMeasurementModel, _ny_of)
from ..ops.linalg import chol_lower, rdiv_chol, symmetrize
from ..ops.matrices import MatLike, as_matspec, resolve_mat
from ..ops.mvnormal import MvNormal, as_mvnormal
from ..utils.signal_names import SignalNames, default_names
from ..utils.struct import struct
from .base import AbstractKalmanFilter
from .kalman import KFState


@struct
class ExtendedKalmanFilter(AbstractKalmanFilter):
    """Nonlinear filter by linearization.

    - ``dynamics``: ``f(x, u, p, t) -> x⁺`` (additive noise)
    - ``measurement_model``: any measurement model; an
      :class:`EKFMeasurementModel` by default
    - ``Ajac``: dynamics Jacobian ``(x, u, p, t) -> A``; defaults to
      ``torch.func.jacfwd`` of the dynamics in ``x``
    - ``alpha``: exponential forgetting like the linear KF
    """

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

    def __post_init__(self):
        o = object.__setattr__
        o(self, "R1", as_matspec(self.R1))
        if self.d0 is None:
            if not isinstance(self.R1, torch.Tensor):
                raise ValueError("d0 must be provided when R1 is not a "
                                 "constant matrix")
            o(self, "d0", as_mvnormal(self.R1))
        else:
            o(self, "d0", as_mvnormal(self.d0))
        ny = self.ny if self.ny >= 0 else getattr(self.measurement_model,
                                                  "ny", -1)
        o(self, "ny", ny)
        if self.names is None:
            o(self, "names", default_names(self.d0.dim, max(self.nu, 0),
                                           max(ny, 0), "EKF"))

    @property
    def nx(self) -> int:
        return self.d0.dim

    @property
    def R2(self):
        return self.measurement_model.R2

    def _Ajac(self, x, u, p, t):
        if self.Ajac is not None:
            return self.Ajac(x, u, p, t)
        return torch.func.jacfwd(lambda xi: self.dynamics(xi, u, p, t))(x)

    def init(self, generator=None) -> KFState:
        return KFState(x=self.d0.mean, R=self.d0.cov, t=0)

    def predict(self, state: KFState, u=None, p=None, t=None, R1=None,
                alpha=None) -> KFState:
        """Linearized time update."""
        p = self.p if p is None else p
        t = state.t * self.Ts if t is None else t
        x, R = state.x, state.R
        R1 = resolve_mat(self.R1, x, u, p, t, Ts=self.Ts) if R1 is None \
            else R1
        a = self.alpha if alpha is None else alpha
        A = self._Ajac(x, u, p, t)
        xn = self.dynamics(x, u, p, t)
        Rn = a * symmetrize(A @ R @ A.mT) + R1
        return KFState(x=xn, R=Rn, t=state.t + 1)

    def correct(self, state: KFState, u, y, p=None, t=None, R2=None,
                mm=None):
        p = self.p if p is None else p
        t = state.t * self.Ts if t is None else t
        model = self.measurement_model if mm is None else mm
        return model.correct(self, state, u, y, p, t, R2=R2)

    def smooth(self, u, y, p=None, sol=None, fused=False, **kwargs):
        """EKF-RTS smoother re-linearizing A at the smoothed point
        (``A = Ajac(xT[t+1], u[t+1], ...)``).

        ``fused=True``: the forward pass through the whole-scan kernels
        (:meth:`forward_trajectory_fused`, kernels H and I); float32 and
        not differentiable."""
        from ..trajectory import forward_trajectory
        from ..utils.solutions import KalmanSmoothingSolution

        p = self.p if p is None else p
        if sol is None and fused:
            sol = self.forward_trajectory_fused(u, y)
        if sol is None:
            sol = forward_trajectory(self, u, y, p, **kwargs)
        x, xt, R, Rt = sol.x, sol.xt, sol.R, sol.Rt
        xT, RT = [xt[-1]], [Rt[-1]]
        for k in range(xt.shape[0] - 2, -1, -1):
            A = self._Ajac(xT[-1], sol.u[k + 1], p, (k + 1) * self.Ts)
            C = rdiv_chol(Rt[k] @ A.mT, chol_lower(R[k + 1]))
            xT.append(xt[k] + C @ (xT[-1] - x[k + 1]))
            RT.append(Rt[k] + symmetrize(C @ (RT[-1] - R[k + 1]) @ C.mT))
        return KalmanSmoothingSolution(sol=sol, xT=torch.stack(xT[::-1]),
                                       RT=torch.stack(RT[::-1]))

    def loglik_fused(self, ys, us=None):
        """Whole-trajectory log-likelihood through the whole-scan kernels
        (kernels/ukf_scan.py::ekf_loglik_fused): kernel H when the
        Jacobians are constant, kernel I otherwise."""
        from ..kernels.ukf_scan import ekf_loglik_fused

        return ekf_loglik_fused(self, ys, us)

    def forward_trajectory_fused(self, us, ys):
        """Full :class:`KalmanFilteringSolution` from the same kernels."""
        from ..kernels.ukf_scan import ekf_forward_trajectory_fused

        return ekf_forward_trajectory_fused(self, us, ys)

    def sample_initial(self, generator, p=None, noise=True):
        return self.d0.sample(generator) if noise else self.d0.mean

    def sample_state(self, generator, x, u, p=None, t=0, noise=True):
        xn = self.dynamics(x, u, p, t)
        if noise:
            R1 = resolve_mat(self.R1, x, u, p, t, Ts=self.Ts)
            xn = xn + as_mvnormal(R1).sample(generator)
        return xn

    def sample_measurement(self, generator, x, u, p=None, t=0, noise=True):
        mm = self.measurement_model
        y = mm(x, u, p, t)
        if noise:
            R2 = resolve_mat(mm.R2, x, u, p, t, Ts=self.Ts)
            y = y + as_mvnormal(R2).sample(generator)
        return y

    def simulate_correlated(self, u, generator, p=None, *,
                            dynamics_noise=True, measurement_noise=True,
                            sample_initial=False):
        """R12-aware joint-noise simulation: draws ``[w; v] ~ N(0, [R1
        R12; R12ᵀ R2])`` so the data carries the modeled cross-covariance.
        Without R12 it is :func:`simulate`."""
        mm = self.measurement_model
        if getattr(mm, "R12", None) is None:
            from ..trajectory import simulate

            return simulate(self, u, generator, p,
                            dynamics_noise=dynamics_noise,
                            measurement_noise=measurement_noise,
                            sample_initial=sample_initial)
        u = torch.as_tensor(u)
        T = u.shape[0]
        p = self.p if p is None else p
        x = self.sample_initial(generator, p, noise=sample_initial)
        nw = self.nx
        xs, ys = [], []
        for k in range(T):
            tk = k * self.Ts
            if k > 0:  # step 0 keeps the initial state, noise-free
                R1, R2, R12 = (resolve_mat(M, x, u[k], p, tk, Ts=self.Ts)
                               for M in (self.R1, mm.R2, mm.R12))
                Rj = torch.cat([torch.cat([R1, R12], 1),
                                torch.cat([R12.mT, R2], 1)], 0)
                wv = as_mvnormal(Rj).sample(generator)
                w = wv[:nw] if dynamics_noise else torch.zeros_like(wv[:nw])
                v = wv[nw:] if measurement_noise else torch.zeros_like(
                    wv[nw:])
                x = self.dynamics(x, u[k], p, tk) + w
                y = mm(x, u[k], p, tk) + v
            else:
                y = mm(x, u[0], p, tk)
            xs.append(x)
            ys.append(y)
        return torch.stack(xs), u, torch.stack(ys)


def make_ekf(dynamics, measurement, R1, R2=None, d0=None, *, nu: int = -1,
             ny: int = -1, Ts: float = 1.0, p=None, alpha=1.0, Ajac=None,
             Cjac=None, R12=None, names=None) -> ExtendedKalmanFilter:
    """Convenience constructor: builds the EKF measurement model from a
    measurement function and R2."""
    if isinstance(measurement, AbstractMeasurementModel):
        mm = measurement
    else:
        R2a = as_matspec(R2)
        mm = EKFMeasurementModel(measurement=measurement, R2=R2a, R12=R12,
                                 Cjac=Cjac, ny=_ny_of(R2a, ny))
    return ExtendedKalmanFilter(
        dynamics=dynamics, measurement_model=mm, R1=R1, d0=d0, p=p,
        alpha=alpha, Ajac=Ajac, Ts=Ts, nu=nu,
        ny=ny if ny >= 0 else mm.ny, names=names)


def make_iekf(dynamics, measurement, R1, R2=None, d0=None, *,
              step: float = 1.0, maxiters: int = 10, epsilon: float = 1e-8,
              Cjac=None, R12=None, **kwargs) -> ExtendedKalmanFilter:
    """Iterated EKF: an EKF with an :class:`IEKFMeasurementModel`."""
    R2a = as_matspec(R2)
    mm = IEKFMeasurementModel(
        measurement=measurement, R2=R2a, R12=R12, Cjac=Cjac, step=step,
        maxiters=maxiters, epsilon=epsilon,
        ny=_ny_of(R2a, kwargs.pop("ny", -1)))
    return make_ekf(dynamics, mm, R1, None, d0, **kwargs)
