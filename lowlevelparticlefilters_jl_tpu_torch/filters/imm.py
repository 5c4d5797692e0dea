"""Interacting Multiple Models filter (counterpart of ``filters/imm.py``).

The mode bank is a tuple of Kalman-family filters whose states expose
Gaussian moments (``.x``, ``.R``): the KF, EKF, UKF (additive or
augmented dynamics) and IEKF compose; the square-root filters keep a
factor and cannot be moment-mixed, as in the JAX package.  Every mode
advances in lock-step; the mode probabilities are updated by the same
stable log-sum-exp as particle weights, and a mode whose mixing mass is
below 1e-6 keeps its own moments (a ``where``, so that autograd through a
sticky transition matrix stays finite).  Each mode steps sequentially:
no kernel takes an IMM, and ``loglik`` differentiates by autograd.
"""
from __future__ import annotations

from typing import Any

import torch

from ..ops.linalg import symmetrize
from ..ops.logsumexp import logsumexp_normalize
from ..utils.signal_names import SignalNames
from ..utils.struct import struct
from .base import AbstractFilter


@struct
class IMMState:
    """The modes' states and the mode probabilities ``mu``."""

    states: tuple
    mu: torch.Tensor
    t: int = 0


@struct
class IMMInfo:
    """``correct``'s outputs: the combined ll, the modes' lls and infos."""

    ll: torch.Tensor
    lls: torch.Tensor
    infos: tuple


@struct
class InteractingMultipleModels(AbstractFilter):
    """IMM over a bank of Kalman-family filters.

    - ``models``: the filters (their states must mean the same thing)
    - ``P``: the mode-transition matrix, rows summing to 1 (P[i, j]: i → j)
    - ``mu0``: the initial mode probabilities
    - ``interact``: run the interaction (mixing) step in ``update``
    """

    models: tuple
    P: torch.Tensor
    mu0: torch.Tensor
    p: Any = None
    interact: bool = True
    names: SignalNames = None

    def __post_init__(self):
        o = object.__setattr__
        o(self, "models", tuple(self.models))
        o(self, "P", torch.as_tensor(self.P))
        o(self, "mu0", torch.as_tensor(self.mu0, dtype=self.P.dtype,
                                       device=self.P.device))
        n = len(self.models)
        if tuple(self.P.shape) != (n, n):
            raise ValueError("P must be (n_modes, n_modes)")
        if tuple(self.mu0.shape) != (n,):
            raise ValueError("mu0 must have one entry per model")
        P, mu0 = self.P.detach(), self.mu0.detach()
        one = torch.ones((), dtype=P.dtype, device=P.device)
        if not torch.allclose(mu0.sum(), one, atol=1e-6):
            raise ValueError("mu0 must sum to 1")
        if not torch.allclose(P.sum(1), one.expand(n), atol=1e-6):
            raise ValueError("P rows must sum to 1")
        if self.names is None:
            o(self, "names", getattr(self.models[0], "names", None))

    @property
    def n_modes(self) -> int:
        return len(self.models)

    @property
    def Ts(self) -> float:
        return self.models[0].Ts

    def init(self, generator=None) -> IMMState:
        return IMMState(states=tuple(m.init() for m in self.models),
                        mu=self.mu0, t=0)

    def _moments(self, state: IMMState):
        xs = torch.stack([m.state(s) for m, s in zip(self.models,
                                                      state.states)])
        Rs = torch.stack([m.covariance(s) for m, s in zip(self.models,
                                                           state.states)])
        return xs, Rs

    def state(self, state: IMMState) -> torch.Tensor:
        """The combined (mode-probability weighted) mean."""
        return torch.einsum("j,jd->d", state.mu, self._moments(state)[0])

    def covariance(self, state: IMMState) -> torch.Tensor:
        """The combined covariance with the spread-of-means term."""
        xs, Rs = self._moments(state)
        d = xs - torch.einsum("j,jd->d", state.mu, xs)
        return torch.einsum("j,jik->ik", state.mu, Rs) + torch.einsum(
            "j,ji,jk->ik", state.mu, d, d)

    def mode_probabilities(self, state: IMMState) -> torch.Tensor:
        return state.mu

    def interact_(self, state: IMMState) -> IMMState:
        """The mixing step: mode j's moments re-mixed with the weights
        ``μ_ij = P[i, j] μ_i / c_j``; a dead mode (c_j <= 1e-6) keeps its
        own."""
        mu, P = state.mu, self.P
        xs, Rs = self._moments(state)
        cj = P.mT @ mu
        alive_j = cj > 1e-6
        safe_cj = torch.where(alive_j, cj, torch.ones_like(cj))
        muij = torch.where(alive_j[None, :], P * mu[:, None] /
                           safe_cj[None, :], torch.zeros_like(P))
        new_x = torch.einsum("ij,id->jd", muij, xs)
        d = xs[:, None, :] - new_x[None, :, :]
        new_R = symmetrize(
            torch.einsum("ij,ija,ijb->jab", muij, d, d)
            + torch.einsum("ij,iab->jab", muij, Rs))
        new_x = torch.where(alive_j[:, None], new_x, xs)
        new_R = torch.where(alive_j[:, None, None], new_R, Rs)
        return state.replace(states=tuple(
            s.replace(x=new_x[j], R=new_R[j])
            for j, s in enumerate(state.states)))

    def predict(self, state: IMMState, u=None, p=None, t=None, **kw
                ) -> IMMState:
        p = self.p if p is None else p
        return IMMState(states=tuple(
            m.predict(s, u, p, t, **kw)
            for m, s in zip(self.models, state.states)),
            mu=state.mu, t=state.t + 1)

    def correct(self, state: IMMState, u, y, p=None, t=None, **kw):
        """Each mode's measurement update, then the mode probabilities:
        ``w = lls + log(Pᵀμ)`` normalized by log-sum-exp; its log-sum is
        the step's ll."""
        p = self.p if p is None else p
        outs = [m.correct(s, u, y, p, t, **kw)
                for m, s in zip(self.models, state.states)]
        infos = tuple(o[1] for o in outs)
        lls = torch.stack([i.ll for i in infos])
        muP = self.P.mT @ state.mu
        w = lls + torch.log(torch.clamp(muP, min=torch.finfo(lls.dtype).tiny))
        _, mu, ll = logsumexp_normalize(w)
        return (IMMState(states=tuple(o[0] for o in outs), mu=mu, t=state.t),
                IMMInfo(ll=ll, lls=lls, infos=infos))

    def update(self, state: IMMState, u, y, p=None, t=None, *, interact=None,
               **kw):
        """correct → interact → predict."""
        do_interact = self.interact if interact is None else interact
        state, info = self.correct(state, u, y, p, t, **kw)
        if do_interact:
            state = self.interact_(state)
        return self.predict(state, u, p, t), info

    def forward_trajectory(self, u, y, p=None, *, interact=None,
                           **_ignored):
        """Batch filtering: the combined moments in ``x/xt/R/Rt``, the mode
        probabilities in ``sol.extra`` [T, n_modes]; ``e``, ``K`` and
        ``S`` are None (the per-mode callbacks are ignored, as in the JAX
        package)."""
        from ..routing import _record
        from ..trajectory import _as_u_seq
        from ..utils.solutions import KalmanFilteringSolution

        T = y.shape[0]
        u_seq = _as_u_seq(u, T, y.dtype, y.device)
        p = self.p if p is None else p
        do_interact = self.interact if interact is None else interact
        state = self.init()
        xs, Rs, xts, Rts, lls, mus = ([] for _ in range(6))
        for k in range(T):
            tk = k * self.Ts
            xs.append(self.state(state))
            Rs.append(self.covariance(state))
            state, info = self.correct(state, u_seq[k], y[k], p, tk)
            xts.append(self.state(state))
            Rts.append(self.covariance(state))
            lls.append(info.ll)
            mus.append(state.mu)
            if do_interact:
                state = self.interact_(state)
            state = self.predict(state, u_seq[k], p, tk)
        xt = torch.stack(xts)
        _record("forward_trajectory", "sequential")
        return KalmanFilteringSolution(
            u=u_seq, y=y, x=torch.stack(xs), xt=xt, R=torch.stack(Rs),
            Rt=torch.stack(Rts), ll=torch.stack(lls).sum(), e=None, K=None,
            S=None, extra=torch.stack(mus),
            t=torch.arange(T, dtype=y.dtype, device=y.device) * self.Ts,
            ok=torch.isfinite(xt).all(-1), route="sequential")

    def loglik(self, u, y, p=None, **kwargs):
        return self.forward_trajectory(u, y, p, **kwargs).ll

    def sample_state(self, generator, x, u, p=None, t=0, noise=True):
        """The ``mu0``-weighted average of the modes' draws."""
        xs = torch.stack([m.sample_state(generator, x, u, p, t, noise=noise)
                          for m in self.models])
        return torch.einsum("j,jd->d", self.mu0, xs)

    def sample_measurement(self, generator, x, u, p=None, t=0, noise=True):
        ys = torch.stack([m.sample_measurement(generator, x, u, p, t,
                                               noise=noise)
                          for m in self.models])
        return torch.einsum("j,jd->d", self.mu0, ys)


IMM = InteractingMultipleModels


def interact(imm: InteractingMultipleModels, state: IMMState) -> IMMState:
    """The IMM mixing step as a function (the reference's ``interact!``),
    returning the mixed state."""
    return imm.interact_(state)


def combine(imm: InteractingMultipleModels, state: IMMState):
    """The IMM moment combination as a function (the reference's
    ``combine!``): ``(x, R)``, the μ-weighted mean and covariance with the
    spread-of-means term."""
    return imm.state(state), imm.covariance(state)
