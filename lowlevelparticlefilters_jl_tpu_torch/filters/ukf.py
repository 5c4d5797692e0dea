"""Unscented Kalman filter with additive or augmented noise forms
(counterpart of ``filters/ukf.py``).

Sigma-point propagation is one ``torch.func.vmap`` over the stacked
[2L+1, L] points; the UT reductions are the ``models/sigmapoints.py``
helpers or the user's overrides.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from ..models.measurement_models import (AbstractMeasurementModel,
                                         UKFMeasurementModel, _ny_of)
from ..models.sigmapoints import (TrivialParams, UTParams, sigmapoints,
                                  ukf_weights, ut_cov, ut_mean)
from ..ops.linalg import blkdiag, chol_lower, rdiv_chol, symmetrize
from ..ops.matrices import MatLike, as_matspec, resolve_mat
from ..ops.mvnormal import MvNormal, as_mvnormal
from ..utils.signal_names import SignalNames, default_names
from ..utils.struct import struct
from .base import AbstractKalmanFilter
from .kalman import KFState


@struct
class UnscentedKalmanFilter(AbstractKalmanFilter):
    """Sigma-point nonlinear state estimator.

    Dynamics forms:
    - additive (default): ``x⁺ = dynamics(x, u, p, t) + w``
    - augmented (``augmented_dynamics=True``): ``x⁺ = dynamics(x, u, p, t,
      w)`` with ``nw`` noise dims drawn into the sigma points.

    ``reject`` drops sigma points (they take the center point's place);
    ``state_mean``/``state_cov`` override the UT reductions for manifold
    states; ``cholesky_fn`` is the pluggable factorization.
    """

    dynamics: Callable
    measurement_model: Any
    R1: MatLike = None
    d0: MvNormal = None
    p: Any = None
    R1x: MatLike = None
    Ts: float = 1.0
    nu: int = -1
    ny: int = -1
    nw: int = 0
    augmented_dynamics: bool = False
    weight_params: UTParams = TrivialParams()
    reject: Optional[Callable] = None
    state_mean: Optional[Callable] = None
    state_cov: Optional[Callable] = None
    cholesky_fn: Optional[Callable] = None
    names: SignalNames = None

    def __post_init__(self):
        o = object.__setattr__
        o(self, "R1", as_matspec(self.R1))
        o(self, "R1x", as_matspec(self.R1x))
        if self.d0 is None:
            if not isinstance(self.R1, torch.Tensor):
                raise ValueError("d0 must be provided when R1 is not a "
                                 "constant matrix")
            o(self, "d0", as_mvnormal(self.R1))
        else:
            o(self, "d0", as_mvnormal(self.d0))
        if self.augmented_dynamics and self.nw == 0:
            if isinstance(self.R1, torch.Tensor):
                o(self, "nw", self.R1.shape[-1])
            else:
                raise ValueError("nw cannot be inferred from R1 when R1 is "
                                 "not a tensor; provide nw explicitly")
        ny = self.ny if self.ny >= 0 else getattr(self.measurement_model,
                                                  "ny", -1)
        o(self, "ny", ny)
        if self.names is None:
            o(self, "names", default_names(self.d0.dim, max(self.nu, 0),
                                           max(ny, 0), "UKF"))

    @property
    def nx(self) -> int:
        return self.d0.dim

    @property
    def R2(self):
        return self.measurement_model.R2

    def init(self, generator=None) -> KFState:
        return KFState(x=self.d0.mean, R=self.d0.cov, t=0)

    def predict(self, state: KFState, u=None, p=None, t=None, R1=None,
                alpha=None) -> KFState:
        """Sigma-point time update."""
        p = self.p if p is None else p
        t = state.t * self.Ts if t is None else t
        x, R = state.x, state.R
        R1 = resolve_mat(self.R1, x, u, p, t, Ts=self.Ts) if R1 is None \
            else R1
        nx = x.shape[-1]
        wp = self.weight_params
        f = self.dynamics
        mean_fn = self.state_mean or ut_mean
        cov_fn = self.state_cov or ut_cov
        vm = torch.func.vmap

        if self.augmented_dynamics:
            nw = self.nw
            # optional state-covariance regularization for explicit
            # disturbance inputs
            if self.R1x is not None:
                R = R + resolve_mat(self.R1x, x, u, p, t, Ts=self.Ts)
            m_aug = torch.cat([x, x.new_zeros(nw)])
            xs0 = sigmapoints(m_aug, blkdiag(R, R1), wp,
                              chol=self.cholesky_fn)
            xsd = vm(lambda s: f(s[:nx], u, p, t, s[nx:]))(xs0)
            L = nx + nw
        else:
            xs0 = sigmapoints(x, R, wp, chol=self.cholesky_fn)
            xsd = vm(lambda s: f(s, u, p, t))(xs0)
            L = nx

        if self.reject is not None:
            rej = vm(self.reject)(xsd[1:])
            xsd = torch.cat([xsd[:1],
                             torch.where(rej[:, None], xsd[:1], xsd[1:])], 0)

        W = ukf_weights(wp, L)
        xn = mean_fn(xsd, W)
        Rn = symmetrize(cov_fn(xsd, xn, W))
        if not self.augmented_dynamics:
            Rn = Rn + R1
        return KFState(x=xn, R=Rn, t=state.t + 1)

    def correct(self, state: KFState, u, y, p=None, t=None, R2=None,
                mm=None):
        p = self.p if p is None else p
        t = state.t * self.Ts if t is None else t
        model = self.measurement_model if mm is None else mm
        return model.correct(self, state, u, y, p, t, R2=R2)

    def smooth(self, u, y, p=None, sol=None, fused=False, **kwargs):
        """Unscented RTS smoother (Särkkä): the backward pass draws
        augmented trivial-weight sigma points of ``(xt, w)`` at every step,
        as the reference does.

        ``fused=True`` runs the forward pass through the whole-scan
        kernels (:meth:`forward_trajectory_fused`: G, or H for an affine
        model); float32 and not differentiable."""
        from ..trajectory import forward_trajectory
        from ..utils.solutions import KalmanSmoothingSolution

        p = self.p if p is None else p
        if sol is None and fused:
            sol = self.forward_trajectory_fused(u, y)
        if sol is None:
            sol = forward_trajectory(self, u, y, p, **kwargs)
        xt, Rt = sol.xt, sol.Rt
        nx = xt.shape[-1]
        f = self.dynamics
        vm = torch.func.vmap
        xT, RT = [xt[-1]], [Rt[-1]]
        for k in range(xt.shape[0] - 2, -1, -1):
            u_k, t_k = sol.u[k], k * self.Ts
            R1 = resolve_mat(self.R1, xt[k], u_k, p, t_k, Ts=self.Ts)
            nw = R1.shape[-1]
            Xs = sigmapoints(torch.cat([xt[k], xt.new_zeros(nw)]),
                             blkdiag(Rt[k], R1), TrivialParams())
            if self.augmented_dynamics:
                Xp = vm(lambda s: f(s[:nx], u_k, p, t_k, s[nx:]))(Xs)
            else:
                Xp = vm(lambda s: f(s[:nx], u_k, p, t_k) + s[nx:])(Xs)
            ns = Xs.shape[0] - 1
            m_pred = Xp.mean(0)
            dP = Xp - m_pred
            P_pred = torch.einsum("si,sj->ij", dP, dP) / ns
            C = torch.einsum("si,sj->ij", Xs[:, :nx] - xt[k], dP) / ns
            D = rdiv_chol(C, chol_lower(P_pred))
            xT.append(xt[k] + D @ (xT[-1] - m_pred))
            RT.append(Rt[k] + symmetrize(D @ (RT[-1] - P_pred) @ D.mT))
        return KalmanSmoothingSolution(sol=sol, xT=torch.stack(xT[::-1]),
                                       RT=torch.stack(RT[::-1]))

    def loglik_fused(self, ys, us=None):
        """Whole-trajectory log-likelihood through the whole-scan kernels
        (kernels/ukf_scan.py::ukf_loglik_fused): kernel G, or kernel H for
        an affine model."""
        from ..kernels.ukf_scan import ukf_loglik_fused

        return ukf_loglik_fused(self, ys, us)

    def forward_trajectory_fused(self, us, ys):
        """Full :class:`KalmanFilteringSolution` from the same kernels."""
        from ..kernels.ukf_scan import ukf_forward_trajectory_fused

        return ukf_forward_trajectory_fused(self, us, ys)

    def sample_initial(self, generator, p=None, noise=True):
        return self.d0.sample(generator) if noise else self.d0.mean

    def sample_state(self, generator, x, u, p=None, t=0, noise=True):
        R1 = resolve_mat(self.R1, x, u, p, t, Ts=self.Ts)
        w = as_mvnormal(R1).sample(generator)
        if not noise:
            w = torch.zeros_like(w)
        if self.augmented_dynamics:
            return self.dynamics(x, u, p, t, w)
        return self.dynamics(x, u, p, t) + w

    def sample_measurement(self, generator, x, u, p=None, t=0, noise=True):
        mm = self.measurement_model
        R2 = resolve_mat(mm.R2, x, u, p, t, Ts=self.Ts)
        e = as_mvnormal(R2).sample(generator)
        if not noise:
            e = torch.zeros_like(e)
        if getattr(mm, "augmented", False):
            return mm.measurement(x, u, p, t, e)
        return mm(x, u, p, t) + e


def make_ukf(dynamics, measurement, R1, R2, d0=None, *, nu: int = -1,
             ny: int = -1, Ts: float = 1.0, p=None,
             augmented_dynamics: bool = False,
             augmented_measurement: bool = False, nw: int = 0, ne: int = 0,
             weight_params: UTParams = TrivialParams(), innovation=None,
             measurement_mean=None, measurement_cov=None, cross_cov=None,
             state_mean=None, state_cov=None, reject=None, cholesky_fn=None,
             names=None) -> UnscentedKalmanFilter:
    """Convenience constructor: builds the UKF measurement model from a
    measurement function and R2."""
    if isinstance(measurement, AbstractMeasurementModel):
        mm = measurement
        if ny < 0:
            ny = mm.ny
    else:
        R2a = as_matspec(R2)
        mm = UKFMeasurementModel(
            measurement=measurement, R2=R2a, ny=_ny_of(R2a, ny), ne=ne,
            augmented=augmented_measurement, innovation=innovation,
            mean=measurement_mean, cov=measurement_cov,
            cross_cov=cross_cov, weight_params=weight_params)
        ny = mm.ny
    return UnscentedKalmanFilter(
        dynamics=dynamics, measurement_model=mm, R1=R1, d0=d0, p=p, Ts=Ts,
        nu=nu, ny=ny, nw=nw, augmented_dynamics=augmented_dynamics,
        weight_params=weight_params, reject=reject, state_mean=state_mean,
        state_cov=state_cov, cholesky_fn=cholesky_fn, names=names)
