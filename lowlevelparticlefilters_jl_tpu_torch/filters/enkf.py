"""Stochastic ensemble Kalman filter with perturbed observations
(counterpart of ``filters/enkf.py``).

The ensemble is one [N, nx] tensor: the members propagate under
``torch.func.vmap`` and the anomaly products ``Xaᵀ Ya`` / ``Yaᵀ Ya`` are
single matrix products.  Where the JAX package splits a PRNG key, the
state carries a ``torch.Generator``; every draw (the initial ensemble,
the process noise, the perturbed observations) goes through
:func:`_sample`, so that a test can replay another stream's draws.
``parallel/sharded.py`` shards the member axis (``sharded_enkf_update``).
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from ..ops.linalg import chol_lower, rdiv_chol, symmetrize
from ..ops.matrices import MatLike, as_matspec, resolve_mat
from ..ops.mvnormal import MvNormal, as_mvnormal, mvnormal_logpdf
from ..utils.signal_names import SignalNames, default_names
from ..utils.struct import struct
from .base import AbstractKalmanFilter
from .kalman import KalmanInfo


@struct
class EnKFState:
    """Ensemble state: members ``X`` [N, nx], the step, the generator."""

    X: torch.Tensor
    t: int = 0
    generator: Optional[torch.Generator] = None


def ensemble_mean(X: torch.Tensor) -> torch.Tensor:
    """Mean over the member axis."""
    return X.mean(-2)


def ensemble_cov(X: torch.Tensor) -> torch.Tensor:
    """Sample covariance with the 1/(N − 1) normalization."""
    N = X.shape[-2]
    Xa = X - ensemble_mean(X)[..., None, :]
    return torch.einsum("...ni,...nj->...ij", Xa, Xa) / (N - 1)


def _sample(d: MvNormal, generator, n: int) -> torch.Tensor:
    """``n`` draws of the Gaussian ``d`` from ``generator``: the one place
    the EnKF (and its sharded step) draws."""
    return d.sample(generator, (n,))


@struct
class EnsembleKalmanFilter(AbstractKalmanFilter):
    """Stochastic EnKF.

    - ``dynamics``: ``f(x, u, p, t) -> x⁺`` (additive process noise R1)
    - ``measurement``: ``h(x, u, p, t) -> y`` (measurement noise R2)
    - ``inflation``: the ensemble spread's factor (>= 1) after the time
      update
    """

    dynamics: Callable
    measurement: Callable
    R1: MatLike = None
    R2: MatLike = None
    d0: MvNormal = None
    N: int = 100
    p: Any = None
    inflation: Any = 1.0
    Ts: float = 1.0
    nu: int = -1
    ny: int = -1
    names: SignalNames = None

    def __post_init__(self):
        o = object.__setattr__
        o(self, "R1", as_matspec(self.R1))
        o(self, "R2", as_matspec(self.R2))
        if self.d0 is None:
            raise ValueError("EnsembleKalmanFilter requires d0 (initial "
                             "density)")
        o(self, "d0", as_mvnormal(self.d0))
        ny = self.ny
        if ny < 0 and isinstance(self.R2, torch.Tensor):
            ny = self.R2.shape[-1]
        o(self, "ny", ny)
        if self.names is None:
            o(self, "names", default_names(self.d0.dim, max(self.nu, 0),
                                           max(ny, 0), "EnKF"))

    @property
    def nx(self) -> int:
        return self.d0.dim

    def init(self, generator: Optional[torch.Generator] = None,
             x0=None) -> EnKFState:
        """N members drawn from d0, recentred on ``x0`` when given."""
        d0 = self.d0 if x0 is None else MvNormal(torch.as_tensor(x0),
                                                 self.d0.cov)
        return EnKFState(X=_sample(d0, generator, self.N), t=0,
                         generator=generator)

    def state(self, state: EnKFState) -> torch.Tensor:
        return ensemble_mean(state.X)

    def covariance(self, state: EnKFState) -> torch.Tensor:
        return ensemble_cov(state.X)

    def predict(self, state: EnKFState, u=None, p=None, t=None, R1=None,
                inflation=None) -> EnKFState:
        """Members through the dynamics, plus process noise, then the
        spread inflated about the mean."""
        p = self.p if p is None else p
        t = state.t * self.Ts if t is None else t
        xbar = ensemble_mean(state.X)
        R1 = resolve_mat(self.R1, xbar, u, p, t, Ts=self.Ts) \
            if R1 is None else R1
        infl = self.inflation if inflation is None else inflation
        f = self.dynamics
        Xp = torch.func.vmap(lambda xi: f(xi, u, p, t))(state.X)
        Xp = Xp + _sample(as_mvnormal(R1), state.generator, self.N)
        m = ensemble_mean(Xp)
        return EnKFState(X=m + infl * (Xp - m), t=state.t + 1,
                         generator=state.generator)

    def correct(self, state: EnKFState, u, y, p=None, t=None, R2=None,
                mm=None):
        """The stochastic update with perturbed observations; returns the
        standard ``(ll, e, S, Schol, K)``."""
        if mm is not None:
            raise NotImplementedError("EnKF uses its own measurement "
                                      "function")
        p = self.p if p is None else p
        t = state.t * self.Ts if t is None else t
        N = self.N
        xbar = ensemble_mean(state.X)
        R2 = resolve_mat(self.R2, xbar, u, p, t, Ts=self.Ts) \
            if R2 is None else R2
        h = self.measurement
        Y = torch.func.vmap(lambda xi: h(xi, u, p, t))(state.X)   # [N, ny]
        ybar = Y.mean(0)
        Xa, Ya = state.X - xbar, Y - ybar
        S = symmetrize(Ya.mT @ Ya / (N - 1)) + R2
        Schol = chol_lower(S)
        K = rdiv_chol(Xa.mT @ Ya / (N - 1), Schol)                # [nx, ny]
        e = y - ybar
        eps = _sample(as_mvnormal(R2), state.generator, N)
        Xn = state.X + (y + eps - Y) @ K.mT
        ll = mvnormal_logpdf(e, torch.zeros_like(e), Schol)
        return (EnKFState(X=Xn, t=state.t, generator=state.generator),
                KalmanInfo(ll=ll, e=e, S=S, Schol=Schol, K=K))

    def forward_trajectory(self, u, y, p=None, *,
                           generator: Optional[torch.Generator] = None,
                           state0: EnKFState = None, **kwargs):
        """Kalman-style batch filtering over the ensemble (the per-step
        callbacks as for a Kalman filter): the solution's moments are the
        ensemble's mean and covariance."""
        from ..routing import _record
        from ..trajectory import kalman_forward_trajectory

        if state0 is None:
            if generator is None:
                raise ValueError("provide generator= (or state0=) for EnKF "
                                 "filtering")
            state0 = self.init(generator)
        _record("forward_trajectory", "sequential")
        return kalman_forward_trajectory(_BoundEnKF(self, state0), u, y, p,
                                         **kwargs).replace(route="sequential")

    def loglik(self, u, y, p=None, *,
               generator: Optional[torch.Generator] = None, state0=None):
        return self.forward_trajectory(u, y, p, generator=generator,
                                       state0=state0).ll

    def sample_initial(self, generator, p=None, noise=True):
        return self.d0.sample(generator) if noise else self.d0.mean

    def sample_state(self, generator, x, u, p=None, t=0, noise=True):
        xn = self.dynamics(x, u, p, t)
        if noise:
            xn = xn + as_mvnormal(resolve_mat(self.R1, x, u, p, t,
                                              Ts=self.Ts)).sample(generator)
        return xn

    def sample_measurement(self, generator, x, u, p=None, t=0, noise=True):
        yy = self.measurement(x, u, p, t)
        if noise:
            yy = yy + as_mvnormal(resolve_mat(self.R2, x, u, p, t,
                                              Ts=self.Ts)).sample(generator)
        return yy


class _BoundEnKF:
    """The EnKF with its initial state bound, for the Kalman trajectory
    driver (whose ``init`` takes no generator)."""

    def __init__(self, enkf: EnsembleKalmanFilter, state0: EnKFState):
        self._enkf = enkf
        self._state0 = state0

    def init(self):
        return self._state0

    def __getattr__(self, name):
        return getattr(self._enkf, name)
