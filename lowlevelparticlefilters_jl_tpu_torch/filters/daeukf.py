"""Unscented Kalman filter for semi-explicit DAEs, Mandela, Rengaswamy &
Narasimhan 2010 (counterpart of ``filters/daeukf.py``):

    ẋ = f(x, z, u),   0 = g(x, z, u),   y = h(x, z, u) + e

``x`` is the differential state (the filtered one) and ``z`` the
algebraic state held on the constraint manifold.  The sigma points span
``x``; each is projected onto the manifold by solving
``residual(x, z, u, p, t) = 0`` for z, warm-started from the previous
descriptor: by default a fixed-iteration damped Newton solve
(:func:`newton_constraint_solver`), batched over the sigma points with
``torch.func.vmap``.  The state carries the descriptor sigma stack
``xzs`` that ``predict`` leaves for ``correct`` (the re-projected points
of the inflated covariance).  The largest constraint residual of a step
is returned in ``info.resnorm`` for callback monitoring, where the
reference warns.  No kernel takes a DAE-UKF.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from ..models.sigmapoints import TrivialParams, UTParams, sigmapoints, \
    ukf_weights
from ..ops.linalg import chol_lower, rdiv_chol, symmetrize
from ..ops.matrices import MatLike, as_matspec, resolve_mat
from ..ops.mvnormal import MvNormal, as_mvnormal, mvnormal_logpdf
from ..utils.signal_names import SignalNames, default_names
from ..utils.struct import struct
from .base import AbstractKalmanFilter
from .mukf import _wvecs


def newton_constraint_solver(iters: int = 15, damping: float = 1.0):
    """A ``(f, z0) -> z`` solver: ``iters`` damped Newton steps, the
    Jacobian by ``torch.func.jacfwd`` and the step by
    ``torch.linalg.solve_ex`` (a singular Jacobian gives non-finite values,
    as in the JAX package, and no host synchronization on the card); it
    runs under ``torch.func.vmap``."""

    def solve(f, z0):
        z = torch.as_tensor(z0)
        for _ in range(iters):
            r = f(z)
            J = torch.func.jacfwd(f)(z)
            z = z - damping * torch.linalg.solve_ex(J, r)[0]
        return z

    return solve


@struct
class DAEUKFState:
    """The differential moments, the on-manifold descriptor ``xz`` and
    the descriptor sigma stack ``xzs`` left by ``predict``."""

    x: torch.Tensor
    R: torch.Tensor
    xz: torch.Tensor
    xzs: torch.Tensor
    t: int = 0


@struct
class DAEUKFInfo:
    """``correct``'s outputs and the norm of the constraint residual at
    the corrected descriptor."""

    ll: torch.Tensor
    e: torch.Tensor
    S: torch.Tensor
    Schol: torch.Tensor
    K: torch.Tensor
    resnorm: Any = 0.0


@struct
class DAEUnscentedKalmanFilter(AbstractKalmanFilter):
    """UKF for semi-explicit DAEs.

    The callbacks (on the full descriptor ``xz`` but ``residual``):
    ``dynamics(xz, u, p, t) -> xz⁺``, ``measurement(xz, u, p, t) -> y``,
    ``residual(x, z, u, p, t) -> g``, ``get_x_z(xz) -> (x, z)``,
    ``build_xz(x, z) -> xz`` and ``constraint_solver(f, z0) -> z``
    (default :func:`newton_constraint_solver`).  ``xz0`` must satisfy
    ``residual(x0, z0) ≈ 0``.
    """

    dynamics: Callable
    measurement: Callable
    residual: Callable
    get_x_z: Callable
    build_xz: Callable
    R1: MatLike = None
    R2: MatLike = None
    d0: MvNormal = None
    xz0: torch.Tensor = None
    p: Any = None
    nu: int = -1
    ny: int = -1
    Ts: float = 1.0
    weight_params: UTParams = TrivialParams()
    constraint_solver: Callable = None
    names: SignalNames = None

    def __post_init__(self):
        o = object.__setattr__
        o(self, "R1", as_matspec(self.R1))
        o(self, "R2", as_matspec(self.R2))
        o(self, "d0", as_mvnormal(self.d0))
        if self.xz0 is None:
            raise ValueError("provide xz0 (initial descriptor on the "
                             "manifold)")
        o(self, "xz0", torch.as_tensor(self.xz0))
        if self.constraint_solver is None:
            o(self, "constraint_solver", newton_constraint_solver())
        ny = self.ny
        if ny < 0 and isinstance(self.R2, torch.Tensor):
            ny = self.R2.shape[-1]
        o(self, "ny", ny)
        if self.names is None:
            o(self, "names", default_names(self.d0.dim, max(self.nu, 0), ny,
                                           "DAEUKF"))

    @property
    def nx(self) -> int:
        return self.d0.dim

    def calc_xz(self, xz, u, p, t, xi):
        """The descriptor of the differential state ``xi``: z solved from
        the constraint, warm-started from ``xz``'s z.  Returns
        ``(descriptor, residual norm)``."""
        z0 = self.get_x_z(xz)[1]
        z = self.constraint_solver(
            lambda zz: self.residual(xi, zz, u, p, t), z0)
        nr = torch.linalg.vector_norm(self.residual(xi, z, u, p, t))
        return self.build_xz(xi, z), nr

    def _calc_all(self, xzs, u, p, t, sp):
        """:meth:`calc_xz` at every sigma point (one vmap)."""
        return torch.func.vmap(
            lambda xz, xi: self.calc_xz(xz, u, p, t, xi)[0])(xzs, sp)

    def init(self, generator=None) -> DAEUKFState:
        xzs = self.xz0.expand(2 * self.nx + 1, self.xz0.shape[-1]).clone()
        return DAEUKFState(x=self.d0.mean, R=self.d0.cov, xz=self.xz0,
                           xzs=xzs, t=0)

    def predict(self, state: DAEUKFState, u=None, p=None, t=None, R1=None
                ) -> DAEUKFState:
        """Mandela et al.'s time update: the sigma points projected on the
        manifold, through the DAE, the moments plus R1, new sigma points
        of the inflated covariance projected again, and the descriptor at
        the predicted mean."""
        p = self.p if p is None else p
        t = state.t * self.Ts if t is None else t
        R1 = resolve_mat(self.R1, state.x, u, p, t, Ts=self.Ts) \
            if R1 is None else R1
        W = ukf_weights(self.weight_params, self.nx)
        vm = torch.func.vmap
        sp = sigmapoints(state.x, state.R, self.weight_params)
        xzs = self._calc_all(state.xzs, u, p, t, sp)
        xzs = vm(lambda xz: self.dynamics(xz, u, p, t))(xzs)
        xs_prop = vm(lambda xz: self.get_x_z(xz)[0])(xzs)
        wm, wc = _wvecs(W, xs_prop.shape[0], xs_prop)
        xm = torch.einsum("s,sd->d", wm, xs_prop)
        d = xs_prop - xm
        Rm = symmetrize(torch.einsum("s,si,sj->ij", wc, d, d)) + R1
        sp2 = sigmapoints(xm, Rm, self.weight_params)
        xzs = self._calc_all(xzs, u, p, t, sp2)
        xz, _ = self.calc_xz(state.xz, u, p, t, xm)
        return DAEUKFState(x=xm, R=Rm, xz=xz, xzs=xzs, t=state.t + 1)

    def correct(self, state: DAEUKFState, u, y, p=None, t=None, R2=None,
                mm=None):
        """The measurement update on the descriptor sigma stack; the
        corrected mean is projected on the manifold."""
        p = self.p if p is None else p
        t = state.t * self.Ts if t is None else t
        R2 = resolve_mat(self.R2, state.x, u, p, t, Ts=self.Ts) \
            if R2 is None else R2
        W = ukf_weights(self.weight_params, self.nx)
        vm = torch.func.vmap
        xzs = state.xzs
        ys = vm(lambda xz: self.measurement(xz, u, p, t))(xzs)
        wm, wc = _wvecs(W, ys.shape[0], ys)
        ym = torch.einsum("s,sd->d", wm, ys)
        dy = ys - ym
        S = symmetrize(torch.einsum("s,si,sj->ij", wc, dy, dy)) + R2
        Schol = chol_lower(S)
        dx = vm(lambda xz: self.get_x_z(xz)[0])(xzs) - state.x
        Kx = rdiv_chol(torch.einsum("s,si,sj->ij", wc, dx, dy), Schol)
        e = y - ym
        x_new = state.x + Kx @ e
        R_new = symmetrize(state.R - Kx @ S @ Kx.mT)
        xz, nr = self.calc_xz(state.xz, u, p, t, x_new)
        ll = mvnormal_logpdf(e, torch.zeros_like(e), Schol)
        return (DAEUKFState(x=x_new, R=R_new, xz=xz, xzs=xzs, t=state.t),
                DAEUKFInfo(ll=ll, e=e, S=S, Schol=Schol, K=Kx, resnorm=nr))

    def sample_initial(self, generator, p=None, noise=True):
        """A differential state from d0, projected on the manifold (the
        simulation carries whole descriptors)."""
        x0 = self.d0.sample(generator) if noise else self.d0.mean
        return self.calc_xz(self.xz0, None, p, 0.0, x0)[0]

    def sample_state(self, generator, x, u, p=None, t=0, noise=True):
        """A descriptor through the DAE, noise added to its differential
        part, projected again."""
        xz1 = self.dynamics(x, u, p, t)
        if noise:
            x1 = self.get_x_z(xz1)[0]
            R1 = resolve_mat(self.R1, x1, u, p, t, Ts=self.Ts)
            xz1 = self.calc_xz(xz1, u, p, t,
                               x1 + as_mvnormal(R1).sample(generator))[0]
        return xz1

    def sample_measurement(self, generator, x, u, p=None, t=0, noise=True):
        yy = self.measurement(x, u, p, t)
        if noise:
            R2 = resolve_mat(self.R2, self.get_x_z(x)[0], u, p, t,
                             Ts=self.Ts)
            yy = yy + as_mvnormal(R2).sample(generator)
        return yy
