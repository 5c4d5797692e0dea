"""Marginalized unscented Kalman filter, Morelande & Moran 2007
(counterpart of ``filters/mukf.py``).

The sigma points span the nonlinear substate only; the conditionally
linear substate enters through its conditional mean
``νB_i = μl + L (sp_i − μn)`` and the analytic terms ``G Γ Gᵀ`` and
``Cl Γ Clᵀ``, with the eq.-16 cross-covariance term ``Γ Cl_avgᵀ`` on the
linear rows.  The model, conditionally linear given xn:

    xn⁺ = dn(xn, u, p, t) + An(xn, ...) xl + wn
    xl⁺ = dl(xn, u, p, t) + Al(xn, ...) xl + wl,  [wn; wl] ~ N(0, R1)
    y   = g(xn, u, p, t) + Cl(xn, ...) xl + e,    e ~ N(0, R2)

``n_inds``/``l_inds`` place the substates anywhere in the state vector.
The (2 nxn + 1) sigma points go through the callbacks in one
``torch.func.vmap``; no kernel takes a MUKF.

The default van der Merwe weights (alpha = 1e-3) put a centre weight of
about -1e6 on a sum whose result is of order one, so the unscented sums
lose about ``|w| eps`` of their value to rounding: 0.1 in float32, where
the filter's output is noise, 2e-10 in float64.  A filter whose weights
lose more than :data:`UT_CANCEL_LIMIT` so in its dtype warns when it is
built; ``MerweParams(alpha=1.0)`` or float64 avoids it.
"""
from __future__ import annotations

import warnings
from typing import Any, Callable

import torch

from ..models.sigmapoints import MerweParams, UTParams, sigmapoints, \
    ukf_weights
from ..ops.linalg import chol_lower, rdiv_chol, symmetrize
from ..ops.matrices import MatLike, as_matspec, resolve_mat
from ..ops.mvnormal import MvNormal, as_mvnormal, mvnormal_logpdf
from ..utils.signal_names import SignalNames, default_names
from ..utils.struct import struct
from .base import AbstractKalmanFilter
from .kalman import KFState, KalmanInfo
from .rbpf import RBMeasurementModel


#: the largest ``max |w| * eps`` that a filter's UT weights may show in
#: its dtype without a warning
UT_CANCEL_LIMIT = 1e-4


def _idx(inds, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(inds, dtype=torch.long, device=like.device)


def partition_cov(P, n_inds, l_inds):
    """A joint covariance's blocks ``(Pnn, Pnl, Pln, Pll)``."""
    n, l = _idx(n_inds, P), _idx(l_inds, P)  # noqa: E741
    return P[n][:, n], P[n][:, l], P[l][:, n], P[l][:, l]


def cond_linear_params(Pnn, Pnl, Pln, Pll):
    """The conditional-Gaussian regression ``L = Pln Pnn⁻¹`` and
    covariance ``Γ = Pll − Pln Pnn⁻¹ Pnl``."""
    L = rdiv_chol(Pln, chol_lower(Pnn))
    return L, Pll - L @ Pnl


def _wvecs(W, S: int, like: torch.Tensor):
    """The UT mean and covariance weights as [S] vectors."""
    def vec(center, rest):
        v = torch.full((S,), rest, dtype=like.dtype, device=like.device)
        v[0] = center
        return v

    return vec(W.wm, W.wmi), vec(W.wc, W.wci)


def _per_point(M, pts, u, p, t, Ts):
    """A matrix spec at every sigma point: ``[S, ...]``."""
    if callable(M):
        return torch.func.vmap(lambda s: resolve_mat(M, s, u, p, t,
                                                     Ts=Ts))(pts)
    Mt = resolve_mat(M, pts[0], u, p, t, Ts=Ts)
    return Mt.expand(pts.shape[0], *Mt.shape)


@struct
class MUKF(AbstractKalmanFilter):
    """Rao-Blackwellized UKF.

    - ``dynamics``: ``(xn, u, p, t) -> [dn; dl]`` in full-state order
    - ``nl_measurement_model``: :class:`RBMeasurementModel` (g, R2)
    - ``A``: the combined ``[An; Al]`` (nx × nxl), a matrix or a callable
      of ``(xn, u, p, t)``; ``Cl``: the linear substate's measurement
      matrix (ny × nxl), likewise
    - ``R1``: the full process noise (nx × nx); ``d0``: the full state's
      initial density; ``nxn``: the nonlinear substate's dimension
    - ``n_inds``/``l_inds``: the substates' positions in the state
      vector (default: the first nxn, the rest)
    """

    dynamics: Callable
    nl_measurement_model: RBMeasurementModel
    A: MatLike = None
    Cl: MatLike = None
    R1: MatLike = None
    d0: MvNormal = None
    nxn: int = -1
    p: Any = None
    Ts: float = 1.0
    nu: int = -1
    ny: int = -1
    weight_params: UTParams = MerweParams()
    n_inds: tuple = None
    l_inds: tuple = None
    names: SignalNames = None

    def __post_init__(self):
        o = object.__setattr__
        for name in ("A", "Cl", "R1"):
            o(self, name, as_matspec(getattr(self, name)))
        o(self, "d0", as_mvnormal(self.d0))
        if self.nxn < 0:
            raise ValueError("provide nxn (nonlinear substate dimension)")
        nx = self.d0.dim
        n_inds = tuple(range(self.nxn)) if self.n_inds is None \
            else tuple(self.n_inds)
        o(self, "n_inds", n_inds)
        o(self, "l_inds", tuple(i for i in range(nx) if i not in n_inds)
          if self.l_inds is None else tuple(self.l_inds))
        ny = self.ny if self.ny >= 0 else self.nl_measurement_model.ny
        o(self, "ny", ny)
        W = ukf_weights(self.weight_params, self.nxn)
        loss = max(abs(W.wm), abs(W.wc), abs(W.wmi), abs(W.wci)) * \
            torch.finfo(self.d0.mean.dtype).eps
        if loss > UT_CANCEL_LIMIT:
            warnings.warn(
                f"MUKF: the UT weights {self.weight_params} have a centre "
                f"weight of {W.wm:.3g}; in {self.d0.mean.dtype} the "
                f"unscented sums lose about {loss:.2g} of their value to "
                f"rounding.  Use float64 or a larger alpha, e.g. "
                f"MerweParams(alpha=1.0).", stacklevel=3)
        if self.names is None:
            o(self, "names", default_names(nx, max(self.nu, 0), max(ny, 0),
                                           "MUKF"))

    @property
    def nx(self) -> int:
        return self.d0.dim

    @property
    def nxl(self) -> int:
        return self.nx - self.nxn

    def init(self, generator=None) -> KFState:
        return KFState(x=self.d0.mean, R=self.d0.cov, t=0)

    def xl_cov(self, state: KFState) -> torch.Tensor:
        """The linear substate's marginal covariance."""
        return partition_cov(state.R, self.n_inds, self.l_inds)[3]

    def _conditional(self, state: KFState):
        n, l = _idx(self.n_inds, state.x), _idx(self.l_inds, state.x)  # noqa
        Pnn, Pnl, Pln, Pll = partition_cov(state.R, self.n_inds, self.l_inds)
        L, Gamma = cond_linear_params(Pnn, Pnl, Pln, Pll)
        mun, mul = state.x[n], state.x[l]
        sp = sigmapoints(mun, Pnn, self.weight_params)     # [2 nxn + 1, nxn]
        W = ukf_weights(self.weight_params, self.nxn)
        nus = mul + (sp - mun) @ L.mT                      # [S, nxl]
        return sp, nus, W, Gamma

    def predict(self, state: KFState, u=None, p=None, t=None, R1=None
                ) -> KFState:
        """The marginalized UT's time update."""
        p = self.p if p is None else p
        t = state.t * self.Ts if t is None else t
        R1 = resolve_mat(self.R1, state.x, u, p, t, Ts=self.Ts) \
            if R1 is None else R1
        sp, nus, W, Gamma = self._conditional(state)
        f = self.dynamics
        G = _per_point(self.A, sp, u, p, t, self.Ts)       # [S, nx, nxl]
        Y = torch.func.vmap(lambda s: f(s, u, p, t))(sp) \
            + (G @ nus[..., None])[..., 0]                 # [S, nx]
        wm, wc = _wvecs(W, sp.shape[0], Y)
        mu_pred = torch.einsum("s,sd->d", wm, Y)
        d = Y - mu_pred
        G_avg = torch.einsum("s,sij->ij", wm, G)
        P_pred = symmetrize(torch.einsum("s,si,sj->ij", wc, d, d)
                            + G_avg @ Gamma @ G_avg.mT) + R1
        return KFState(x=mu_pred, R=P_pred, t=state.t + 1)

    def correct(self, state: KFState, u, y, p=None, t=None, R2=None,
                mm=None):
        """The marginalized UT's measurement update with the eq.-16
        cross-covariance term."""
        p = self.p if p is None else p
        t = state.t * self.Ts if t is None else t
        model = self.nl_measurement_model if mm is None else mm
        g = model.measurement
        if R2 is None:
            R2 = resolve_mat(getattr(model.R2, "cov", model.R2), state.x, u,
                             p, t, Ts=self.Ts)
        sp, nus, W, Gamma = self._conditional(state)
        S_n = sp.shape[0]
        Cls = _per_point(self.Cl, sp, u, p, t, self.Ts)    # [S, ny, nxl]
        Ym = torch.func.vmap(lambda s: g(s, u, p, t))(sp) \
            + (Cls @ nus[..., None])[..., 0]               # [S, ny]
        wm, wc = _wvecs(W, S_n, Ym)
        yhat = torch.einsum("s,sd->d", wm, Ym)
        dy = Ym - yhat
        Cl_avg = torch.einsum("s,sij->ij", wm, Cls)
        S_mat = symmetrize(torch.einsum("s,si,sj->ij", wc, dy, dy)
                           + Cl_avg @ Gamma @ Cl_avg.mT) + R2
        Schol = chol_lower(S_mat)
        # the full-state sigma stack: sp at n_inds, νB at l_inds
        n, l = _idx(self.n_inds, sp), _idx(self.l_inds, sp)  # noqa: E741
        Xf = sp.new_zeros((S_n, self.nx))
        Xf = Xf.index_copy(1, n, sp).index_copy(1, l, nus)
        Sxy = torch.einsum("s,si,sj->ij", wc, Xf - state.x, dy)
        Sxy = Sxy.index_add(0, l, Gamma @ Cl_avg.mT)      # eq. 16
        K = rdiv_chol(Sxy, Schol)
        e = y - yhat
        x_new = state.x + K @ e
        R_new = symmetrize(state.R - K @ S_mat @ K.mT)
        ll = mvnormal_logpdf(e, torch.zeros_like(e), Schol)
        return (KFState(x=x_new, R=R_new, t=state.t),
                KalmanInfo(ll=ll, e=e, S=S_mat, Schol=Schol, K=K))

    def _split(self, x):
        return x[_idx(self.n_inds, x)], x[_idx(self.l_inds, x)]

    def _full_dynamics(self, x, u, p, t):
        xn, xl = self._split(x)
        return self.dynamics(xn, u, p, t) + resolve_mat(
            self.A, xn, u, p, t, Ts=self.Ts) @ xl

    def _full_measurement(self, x, u, p, t):
        xn, xl = self._split(x)
        return self.nl_measurement_model.measurement(xn, u, p, t) \
            + resolve_mat(self.Cl, xn, u, p, t, Ts=self.Ts) @ xl

    def sample_initial(self, generator, p=None, noise=True):
        return self.d0.sample(generator) if noise else self.d0.mean

    def sample_state(self, generator, x, u, p=None, t=0, noise=True):
        xn = self._full_dynamics(x, u, p, t)
        if noise:
            xn = xn + as_mvnormal(resolve_mat(self.R1, x, u, p, t,
                                              Ts=self.Ts)).sample(generator)
        return xn

    def sample_measurement(self, generator, x, u, p=None, t=0, noise=True):
        yy = self._full_measurement(x, u, p, t)
        if noise:
            yy = yy + self.nl_measurement_model.R2.sample(generator)
        return yy
