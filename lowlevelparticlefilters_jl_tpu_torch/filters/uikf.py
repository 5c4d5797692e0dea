"""Unknown-input Kalman filter, Gillijns & De Moor 2007 (counterpart of
``filters/uikf.py``).

Joint input and state estimation for ``x⁺ = Ax + Bu + G d + w`` with the
unknown input ``d``: a weighted-least-squares input estimate, then a
Kalman gain projected onto the rank-(ny − nd) subspace where the
modified innovation covariance is regular (an SVD, Theorem 8 of the
paper).  Needs rank(C G) = nd; a lower rank shows as NaNs in ``sol.ok``.

The filter forwards unknown attributes to its inner KF, as in the JAX
package; the routing predicates test ``type(f)``, so a UIKF never takes
a KF's kernel (H, K): every verb runs its own sequential recursion.
"""
from __future__ import annotations

import torch

from ..ops.linalg import chol_lower, rdiv_chol, symmetrize
from ..ops.matrices import MatLike, as_matspec, resolve_mat
from ..ops.mvnormal import mvnormal_logpdf
from ..utils.struct import struct
from .base import AbstractKalmanFilter
from .kalman import KalmanFilter, KFState, _has_input


@struct
class UIKFInfo:
    """``(ll, e, S, Schol, K)`` plus the unknown-input estimate ``d`` and
    its WLS matrix ``M``."""

    ll: torch.Tensor
    e: torch.Tensor
    S: torch.Tensor
    Schol: torch.Tensor
    K: torch.Tensor
    d: torch.Tensor
    M: torch.Tensor


@struct
class UIKalmanFilter(AbstractKalmanFilter):
    """A :class:`KalmanFilter` with the unknown-input matrix ``G``; ``nd``
    (the unknown-input channels) is inferred from a constant G."""

    kf: KalmanFilter
    G: MatLike
    nd: int = -1

    def __post_init__(self):
        o = object.__setattr__
        o(self, "G", as_matspec(self.G))
        nd = self.nd
        if nd < 0:
            if isinstance(self.G, torch.Tensor) and self.G.ndim == 2:
                nd = self.G.shape[-1]
            else:
                raise ValueError("provide nd when G is not a constant "
                                 "matrix")
        o(self, "nd", nd)

    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, "kf"), name)

    def init(self, generator=None) -> KFState:
        return self.kf.init()

    def predict(self, state, u=None, p=None, t=None, **kw):
        return self.kf.predict(state, u, p, t, **kw)

    def correct(self, state: KFState, u, y, p=None, t=None, R2=None,
                mm=None):
        """The WLS input estimate and the rank-deficient gain update (the
        paper's eqs. 4-7, 12-13, 25, 28-32)."""
        kf = self.kf
        p = kf.p if p is None else p
        t = state.t * kf.Ts if t is None else t
        x, R = state.x, state.R
        C = resolve_mat(kf.C, x, u, p, t, Ts=kf.Ts)
        D = resolve_mat(kf.D, x, u, p, t, Ts=kf.Ts)
        Gm = resolve_mat(self.G, x, u, p, t, Ts=kf.Ts)
        R2 = resolve_mat(kf.R2, x, u, p, t, Ts=kf.Ts) if R2 is None else R2
        ny, nd = C.shape[0], self.nd
        eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
        feed = D is not None and _has_input(u)

        # innovation (eq 7) and its covariance (eq 12)
        e = y - C @ x
        if feed:
            e = e - D @ u
        Rt = symmetrize(C @ R @ C.mT) + R2
        Rt_chol = chol_lower(Rt)

        # WLS input estimate M = (Fᵀ R̃⁻¹ F)⁻¹ Fᵀ R̃⁻¹, d = M e (eqs 13, 4)
        F = C @ Gm
        FtRinv = rdiv_chol(F.mT, Rt_chol)
        M = torch.linalg.solve_ex(symmetrize(FtRinv @ F), FtRinv)[0]
        d = M @ e

        # input-corrected state and covariance (eqs 5, 25)
        x_star = x + Gm @ d
        I_GMC = eye - Gm @ M @ C
        R_star = symmetrize(I_GMC @ R @ I_GMC.mT) \
            + Gm @ M @ R2 @ M.mT @ Gm.mT

        # corrected innovation (eq 6)
        e_star = y - C @ x_star
        if feed:
            e_star = e_star - D @ u

        # the state-error / measurement-noise correlation (eq 29) and the
        # singular modified innovation covariance (eqs 28-30)
        S_star = -Gm @ M @ R2
        I_CGM = torch.eye(ny, dtype=x.dtype, device=x.device) - C @ Gm @ M
        Rt_star = symmetrize(I_CGM @ Rt @ I_CGM.mT)

        # Theorem 8: alpha spans the rank-(ny - nd) subspace, with the
        # upper factor R̃ = UᵀU (the gain below does not depend on the
        # basis the SVD picks)
        Usqrt = Rt_chol.mT
        F_norm = torch.linalg.solve_triangular(Usqrt.mT, F, upper=False)
        U_svd = torch.linalg.svd(F_norm, full_matrices=True)[0]
        alpha = torch.linalg.solve_triangular(Usqrt, U_svd[:, nd:],
                                              upper=True).mT

        # projected gain (eq 32) and the update
        V_star = R_star @ C.mT + S_star
        aRa = symmetrize(alpha @ Rt_star @ alpha.mT)
        K = V_star @ rdiv_chol(alpha.mT, chol_lower(aRa)) @ alpha
        x_new = x_star + K @ e_star
        R_new = symmetrize(R_star - K @ V_star.mT)
        ll = mvnormal_logpdf(e, torch.zeros_like(e), Rt_chol)
        info = UIKFInfo(ll=ll, e=e_star, S=Rt, Schol=Rt_chol, K=K, d=d, M=M)
        return KFState(x=x_new, R=R_new, t=state.t), info

    def forward_trajectory(self, u, y, p=None, *, post_correct_cb=None,
                           **kwargs):
        """Batch filtering with the input estimates in ``sol.extra``
        ([T, nd]); a user's ``post_correct_cb`` runs first and its state
        is kept."""
        from ..routing import _record
        from ..trajectory import kalman_forward_trajectory

        def cb(f, state, info, uk, yk, pk, tk):
            out = post_correct_cb(f, state, info, uk, yk, pk, tk) \
                if post_correct_cb else None
            if out is not None:
                state, _ = out
            return state, info.d

        _record("forward_trajectory", "sequential")
        return kalman_forward_trajectory(self, u, y, p, post_correct_cb=cb,
                                         **kwargs).replace(route="sequential")

    def sample_initial(self, generator, p=None, noise=True):
        return self.kf.sample_initial(generator, p, noise=noise)

    def sample_state(self, generator, x, u, p=None, t=0, noise=True, d=None):
        xn = self.kf.sample_state(generator, x, u, p, t, noise=noise)
        if d is not None:
            xn = xn + resolve_mat(self.G, x, u, p, t, Ts=self.kf.Ts) @ d
        return xn

    def sample_measurement(self, generator, x, u, p=None, t=0, noise=True):
        return self.kf.sample_measurement(generator, x, u, p, t, noise=noise)
