"""Rao-Blackwellized (marginalized) particle filter (counterpart of
``filters/rbpf.py``), "model 2" of Schön, Gustafsson & Nordlund (2004):

    xn⁺ = f(xn, u, p, t) + An xl + wn,   wn ~ R1n
    xl⁺ = A xl + B u + wl,               wl ~ R1l
    y   = g(xn, u, p, t) + C xl + e,     e  ~ R2

The cloud is struct-of-arrays, ``(xn [N, nxn], xl [N, nxl], R)``, and
the per-particle Kalman updates are batched tensor algebra over the
particle axis.  With constant An, A, C and R1 every particle shares one
covariance recursion (``single_riccati``: ``R`` is [nxl, nxl], else
[N, nxl, nxl]).

Resampling is joint over the rows ``[xn, xl, (R)]``: systematic
resampling is ``ops/resample.resample_gather``, which on CUDA
tensors is one launch of kernel E's slot stage (the slot boundaries K)
and one of kernel B (the gather) at any row width.  The Neff decision is
taken on the host each step (one synchronization a step).  Every draw
(the initial cloud, the resampling offset r, taken every step as the
JAX package splits its key every step, and the process noise) goes
through :func:`_sample`, so that a test can replay another stream's
draws.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from ..ops.linalg import chol_lower, rdiv_chol, symmetrize
from ..ops.logsumexp import effective_particles, logsumexp_normalize
from ..ops.matrices import MatLike, as_matspec, resolve_mat
from ..ops.mvnormal import as_mvnormal, mvnormal_logpdf
from ..ops.resample import resample_gather
from ..utils.signal_names import SignalNames
from ..utils.solutions import ParticleFilteringSolution
from ..utils.struct import struct
from .base import AbstractParticleFilter
from .kalman import KalmanFilter, _has_input
from .particle import PFInfo, _uniform_weights


@struct
class RBState:
    """The struct-of-arrays RBParticle cloud; ``R`` is [nxl, nxl] on the
    shared-Riccati path, else [N, nxl, nxl]."""

    xn: torch.Tensor
    xl: torch.Tensor
    R: torch.Tensor
    w: torch.Tensor
    we: torch.Tensor
    t: int = 0
    generator: Optional[torch.Generator] = None


def _sample(d, generator, n: int, like: torch.Tensor = None):
    """The one place the RBPF draws: ``n`` draws of the density ``d`` from
    ``generator``, or, with ``d`` None, the systematic-resampling offset r
    (one uniform on [0, 1) of ``like``'s dtype and device)."""
    if d is None:
        return torch.rand((), generator=generator, dtype=like.dtype,
                          device=like.device)
    return d.sample(generator, (n,))


@struct
class RBMeasurementModel:
    """``y = g(xn, u, p, t) + C xl + e``; ``R2`` may be any density with
    ``logpdf``/``sample`` when the inner KF's C is zero, otherwise a
    Gaussian (a covariance matrix becomes one)."""

    measurement: Callable
    R2: Any = None
    ny: int = -1

    def __post_init__(self):
        if self.R2 is not None and hasattr(self.R2, "shape"):
            object.__setattr__(self, "R2", as_mvnormal(self.R2))


@struct
class RBPF(AbstractParticleFilter):
    """Marginalized particle filter.

    - ``kf``: the linear substate's KalmanFilter (A, B, C, R1, d0)
    - ``dynamics``: the nonlinear part ``f(xn, u, p, t)``
    - ``nl_measurement_model``: :class:`RBMeasurementModel`
    - ``R1n``, ``d0n``: the nonlinear state's noise and initial density
    - ``An``: the linear state's influence on the nonlinear one (or None)
    - ``augmented_dynamics``: with ``An`` None, the noise goes into
      ``f(xn, u, p, t, w)`` instead of being added
    - ``single_riccati``: one covariance recursion for all particles (by
      default when An, A, C and R1 are constant matrices)
    """

    N: int
    kf: KalmanFilter
    dynamics: Callable
    nl_measurement_model: RBMeasurementModel
    R1n: Any = None
    d0n: Any = None
    An: MatLike = None
    p: Any = None
    resample_threshold: float = 0.1
    resampling_strategy: str = "systematic"
    Ts: float = 1.0
    nu: int = -1
    augmented_dynamics: bool = False
    single_riccati: Optional[bool] = None
    zero_C: Optional[bool] = None
    names: SignalNames = None

    def __post_init__(self):
        o = object.__setattr__
        o(self, "An", as_matspec(self.An))
        if self.R1n is not None and hasattr(self.R1n, "shape"):
            o(self, "R1n", as_mvnormal(self.R1n))
        o(self, "d0n", as_mvnormal(self.d0n))
        if self.single_riccati is None:
            def const(M):
                return M is None or isinstance(M, torch.Tensor)

            o(self, "single_riccati", const(self.An) and const(self.kf.A)
              and const(self.kf.R1) and const(self.kf.C))
        if self.zero_C is None:
            C = self.kf.C
            o(self, "zero_C", C is None or (isinstance(C, torch.Tensor)
                                            and bool((C == 0).all())))

    @property
    def nxn(self) -> int:
        return self.d0n.dim

    @property
    def nxl(self) -> int:
        return self.kf.d0.dim

    @property
    def nx(self) -> int:
        return self.nxn + self.nxl

    @property
    def ny(self) -> int:
        return self.nl_measurement_model.ny

    def init(self, generator: Optional[torch.Generator] = None) -> RBState:
        xn = _sample(self.d0n, generator, self.N)
        xl = self.kf.d0.mean.expand(self.N, self.nxl).clone()
        R0 = self.kf.d0.cov
        R = R0.clone() if self.single_riccati else R0.expand(
            self.N, self.nxl, self.nxl).clone()
        w, we = _uniform_weights(self.N, xn)
        return RBState(xn=xn, xl=xl, R=R, w=w, we=we, t=0,
                       generator=generator)

    def state(self, state: RBState) -> torch.Tensor:
        """The weighted mean of the full [xn; xl] state."""
        return torch.einsum("n,nd->d", state.we,
                            torch.cat([state.xn, state.xl], -1))

    def correct(self, state: RBState, u, y, p=None, t=None):
        """The weight update and every particle's KF measurement update,
        batched over the particles."""
        p = self.p if p is None else p
        t = state.t * self.Ts if t is None else t
        kf = self.kf
        g = self.nl_measurement_model.measurement
        yn = torch.func.vmap(lambda xi: g(xi, u, p, t))(state.xn)  # [N, ny]
        if self.zero_C:
            # C == 0: a plain PF weight update with any R2 density
            logp = self.nl_measurement_model.R2.logpdf(y - yn)
            w, we, ll = logsumexp_normalize(state.w + logp)
            return state.replace(w=w, we=we), PFInfo(
                ll=ll, e=torch.zeros_like(y))
        x0 = state.xn[0]
        C = resolve_mat(kf.C, x0, u, p, t, Ts=self.Ts)
        R2 = resolve_mat(self.nl_measurement_model.R2.cov, x0, u, p, t,
                         Ts=self.Ts)
        e = y - yn - state.xl @ C.mT                              # [N, ny]
        eye = torch.eye(self.nxl, dtype=e.dtype, device=e.device)
        S = symmetrize(C @ state.R @ C.mT) + R2
        Schol = chol_lower(S)
        K = rdiv_chol(state.R @ C.mT, Schol)
        Rn = symmetrize((eye - K @ C) @ state.R)
        if self.single_riccati:   # one gain for every particle
            xl = state.xl + e @ K.mT
        else:                     # [N, nxl, ny] gains
            xl = state.xl + (K @ e[..., None])[..., 0]
        lls = mvnormal_logpdf(e, torch.zeros_like(y), Schol)       # [N]
        w, we, ll = logsumexp_normalize(state.w + lls)
        return state.replace(xl=xl, R=Rn, w=w, we=we), PFInfo(
            ll=ll, e=torch.zeros_like(y))

    def _resample(self, state: RBState) -> RBState:
        """Joint resampling of ``[xn, xl, (R)]`` when the Neff trigger
        fires (decided on the host).  The offset r is drawn every step."""
        N = self.N
        r = _sample(None, state.generator, 0, like=state.we)
        if self.resample_threshold < 1.0 and not bool(
                effective_particles(state.we) < self.resample_threshold * N):
            return state
        flat = [state.xn, state.xl]
        if not self.single_riccati:
            flat.append(state.R.reshape(N, -1))
        X = resample_gather(torch.cat(flat, -1), state.we, state.generator,
                            self.resampling_strategy, r=r)
        nxn, nxl = self.nxn, self.nxl
        R = state.R if self.single_riccati else X[:, nxn + nxl:].reshape(
            N, nxl, nxl)
        w, we = _uniform_weights(N, state.w)
        return state.replace(xn=X[:, :nxn], xl=X[:, nxn:nxn + nxl], R=R,
                             w=w, we=we)

    def predict(self, state: RBState, u=None, p=None, t=None) -> RBState:
        """The coupled time update (eqs. 22-28 of the paper), after the
        resampling."""
        p = self.p if p is None else p
        t = state.t * self.Ts if t is None else t
        state = self._resample(state)
        kf, N, f = self.kf, self.N, self.dynamics
        vm = torch.func.vmap
        x0 = state.xn[0]
        Al = resolve_mat(kf.A, x0, u, p, t, Ts=self.Ts)
        Bl = resolve_mat(kf.B, x0, u, p, t, Ts=self.Ts)
        R1l = resolve_mat(kf.R1, x0, u, p, t, Ts=self.Ts)
        An = None if self.An is None else resolve_mat(self.An, x0, u, p, t,
                                                      Ts=self.Ts)
        xl_drive = state.xl @ Al.mT
        if Bl is not None and _has_input(u):
            xl_drive = xl_drive + Bl @ u
        R = state.R
        if An is None:
            # decoupled: any R1n density
            wn = _sample(self.R1n, state.generator, N)
            if self.augmented_dynamics:
                xn1 = vm(lambda xi, wi: f(xi, u, p, t, wi))(state.xn, wn)
            else:
                xn1 = vm(lambda xi: f(xi, u, p, t))(state.xn) + wn
            xl1 = xl_drive
            R1 = symmetrize(Al @ R @ Al.mT) + R1l
        else:
            # coupled (Gaussian R1n): the nonlinear state's noise informs
            # the linear state through the gain L
            fi = vm(lambda xi: f(xi, u, p, t))(state.xn)
            wn = _sample(self.R1n, state.generator, N)
            Nt = symmetrize(An @ R @ An.mT) + self.R1n.cov
            L = rdiv_chol(Al @ R @ An.mT, chol_lower(Nt))
            R1 = symmetrize(Al @ R @ Al.mT) + R1l - symmetrize(L @ Nt @ L.mT)
            xl1 = xl_drive + (wn @ L.mT if self.single_riccati
                              else (L @ wn[..., None])[..., 0])
            xn1 = fi + state.xl @ An.mT + wn
        return RBState(xn=xn1, xl=xl1, R=R1, w=state.w, we=state.we,
                       t=state.t + 1, generator=state.generator)

    def _start(self, u, y, p, generator, state0):
        from ..trajectory import _as_u_seq

        u_seq = _as_u_seq(u, y.shape[0], y.dtype, y.device)
        p = self.p if p is None else p
        return u_seq, p, self.init(generator) if state0 is None else state0

    def forward_trajectory(self, u, y, p=None, *,
                           generator: Optional[torch.Generator] = None,
                           state0: RBState = None, **_ignored):
        """PF-style batch filtering; the solution's particles are the
        concatenated [xn, xl] cloud.  The per-step callbacks are accepted
        and ignored, as in the JAX package."""
        from ..routing import _record

        u_seq, p, state = self._start(u, y, p, generator, state0)
        lls, xs, ws, wes = [], [], [], []
        for k in range(y.shape[0]):
            tk = k * self.Ts
            state, info = self.correct(state, u_seq[k], y[k], p, tk)
            lls.append(info.ll)
            xs.append(torch.cat([state.xn, state.xl], -1))
            ws.append(state.w)
            wes.append(state.we)
            state = self.predict(state, u_seq[k], p, tk)
        _record("forward_trajectory", "sequential")
        return ParticleFilteringSolution(
            u=u_seq, y=y, x=torch.stack(xs), w=torch.stack(ws),
            we=torch.stack(wes), ll=torch.stack(lls).sum(),
            route="sequential")

    def loglik(self, u, y, p=None, *,
               generator: Optional[torch.Generator] = None, state0=None):
        """``forward_trajectory(...).ll`` without storing the cloud's
        history (the same steps and draws)."""
        u_seq, p, state = self._start(u, y, p, generator, state0)
        ll = y.new_zeros(())
        for k in range(y.shape[0]):
            state, info = self.update(state, u_seq[k], y[k], p, k * self.Ts)
            ll = ll + info.ll
        return ll

    def sample_initial(self, generator, p=None, noise=True):
        xn = self.d0n.sample(generator) if noise else self.d0n.mean
        xl = self.kf.d0.sample(generator) if noise else self.kf.d0.mean
        return torch.cat([xn, xl])

    def sample_state(self, generator, x, u, p=None, t=0, noise=True):
        xn, xl = x[:self.nxn], x[self.nxn:]
        xn1 = self.dynamics(xn, u, p, t)
        if noise:
            xn1 = xn1 + self.R1n.sample(generator)
        if self.An is not None:
            xn1 = xn1 + resolve_mat(self.An, xn, u, p, t, Ts=self.Ts) @ xl
        xl1 = resolve_mat(self.kf.A, xn, u, p, t, Ts=self.Ts) @ xl
        Bl = resolve_mat(self.kf.B, xn, u, p, t, Ts=self.Ts)
        if Bl is not None and _has_input(u):
            xl1 = xl1 + Bl @ u
        if noise:
            xl1 = xl1 + as_mvnormal(resolve_mat(
                self.kf.R1, xn, u, p, t, Ts=self.Ts)).sample(generator)
        return torch.cat([xn1, xl1])

    def sample_measurement(self, generator, x, u, p=None, t=0, noise=True):
        xn, xl = x[:self.nxn], x[self.nxn:]
        yy = self.nl_measurement_model.measurement(xn, u, p, t)
        C = resolve_mat(self.kf.C, xn, u, p, t, Ts=self.Ts)
        if C is not None:
            yy = yy + C @ xl
        if noise:
            yy = yy + self.nl_measurement_model.R2.sample(generator)
        return yy


RBParticle = RBState
