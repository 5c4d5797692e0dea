"""Smoothers: RTS, modified Bryson–Frazier, FFBS particle smoother
(counterpart of ``smoothing.py``).

The backward recursions are reversed Python loops over the steps (the
JAX package's reversed ``lax.scan``s).  The FFBS smoother evaluates the
whole (M × N) backward-weight matrix of a step at once; on CUDA float32
data with a Gaussian dynamics density the whole backward pass is kernel J
(kernels/ffbs.py).  Where the JAX package takes a PRNG key, these take a
``torch.Generator``.
"""
from __future__ import annotations

from typing import Optional

import torch

from .ops.linalg import chol_lower, rdiv_chol, symmetrize
from .ops.matrices import resolve_mat
from .trajectory import _as_u_seq, forward_trajectory
from .utils.solutions import KalmanFilteringSolution, KalmanSmoothingSolution

#: ``ffbs_smooth`` backends: ``"kernel"`` is the JAX package's
#: ``"pallas"`` (kernel J or an error), ``"plain"`` its ``"xla"``
FFBS_BACKENDS = ("auto", "kernel", "plain")


def smooth(f, u, y, p=None, M: Optional[int] = None,
           generator: Optional[torch.Generator] = None,
           method: str = "auto", **kwargs):
    """RTS smoothing for Kalman-type filters; FFBS for particle filters.

    ``method="auto"`` sends a long KF/UKF/EKF trajectory on CUDA tensors
    to the O(log T) temporal-parallel smoothers (parallel/temporal.py:
    exact in one pass on linear and affine models, iterated otherwise);
    ``"parallel"`` does so on any device, ``"sequential"`` keeps the
    classic backward pass (routing.py::route_smooth).
    ``last_route("smooth")`` names the path.
    """
    from .routing import last_route, route_smooth

    if M is None and generator is None:
        routed = route_smooth(f, u, y, p, method, kwargs)
        if routed is not None:
            return routed.replace(sol=routed.sol.replace(
                route=last_route("smooth")))
    if hasattr(f, "smooth"):
        if M is not None:
            kwargs["M"] = M
        if generator is not None:
            kwargs["generator"] = generator
        return f.smooth(u, y, p, **kwargs)
    if M is not None or generator is not None:
        raise TypeError("particle smoothing requires a particle filter")
    sol = forward_trajectory(f, u, y, p, **kwargs)
    return rts_smooth(sol, f, p)


def rts_smooth(sol: KalmanFilteringSolution, kf, p=None
               ) -> KalmanSmoothingSolution:
    """Rauch–Tung–Striebel backward pass:
    ``C_t = Rt[t] A_tᵀ R[t+1]⁻¹``, ``xT[t] = xt[t] + C (xT[t+1] − x[t+1])``,
    ``RT[t] = Rt[t] + C (RT[t+1] − R[t+1]) Cᵀ``."""
    x, xt, R, Rt = sol.x, sol.xt, sol.R, sol.Rt
    T = xt.shape[0]
    Ts = getattr(kf, "Ts", 1.0)
    p = getattr(kf, "p", None) if p is None else p
    xT, RT = [xt[-1]], [Rt[-1]]
    for k in range(T - 2, -1, -1):
        At = resolve_mat(kf.A, xt[k], sol.u[k], p, k * Ts, Ts=Ts)
        C = rdiv_chol(Rt[k] @ At.mT, chol_lower(R[k + 1]))
        xT.append(xt[k] + C @ (xT[-1] - x[k + 1]))
        RT.append(Rt[k] + symmetrize(C @ (RT[-1] - R[k + 1]) @ C.mT))
    return KalmanSmoothingSolution(sol=sol, xT=torch.stack(xT[::-1]),
                                   RT=torch.stack(RT[::-1]))


def smooth_mbf(sol: KalmanFilteringSolution, kf, p=None):
    """Modified Bryson–Frazier smoother: no state covariance is inverted;
    the stored innovations, gains and innovation covariances are used
    instead.  Returns ``(ssol, ll, lam_tilde, lam_hat, r)``."""
    xt, Rt = sol.xt, sol.Rt
    T, nx = xt.shape
    Ts = getattr(kf, "Ts", 1.0)
    p = getattr(kf, "p", None) if p is None else p
    eye = torch.eye(nx, dtype=xt.dtype, device=xt.device)
    lam_hat = xt.new_zeros(nx)
    Lam_hat = xt.new_zeros(nx, nx)
    outs = []
    for k in range(T - 1, -1, -1):
        H = resolve_mat(kf.C, xt[k], sol.u[k], p, k * Ts, Ts=Ts)
        Cm = eye - sol.K[k] @ H
        HTS = rdiv_chol(H.mT, chol_lower(sol.S[k]))
        r_k = Cm.mT @ lam_hat
        lam_tilde = -HTS @ sol.e[k] + Cm.mT @ lam_hat
        Lam_tilde = HTS @ H + Cm.mT @ Lam_hat @ Cm
        # the transition (k-1) -> k is A resolved at step k-1; step 0
        # reuses its own (a fixed shift, as in the JAX package)
        kp = max(k - 1, 0)
        F = resolve_mat(kf.A, xt[kp], sol.u[kp], p, kp * Ts, Ts=Ts)
        xT_k = xt[k] - Rt[k] @ lam_hat
        RT_k = Rt[k] - symmetrize(Rt[k] @ Lam_hat @ Rt[k])
        outs.append((xT_k, RT_k, lam_tilde, lam_hat, r_k))
        lam_hat, Lam_hat = F.mT @ lam_tilde, F.mT @ Lam_tilde @ F
    xT, RT, lam_tilde, lam_hat, r = (torch.stack(list(v)[::-1])
                                     for v in zip(*outs))
    return (KalmanSmoothingSolution(sol=sol, xT=xT, RT=RT), sol.ll,
            lam_tilde, lam_hat, r)


# ---------------------------------------------------------------------------
# Particle smoothing: forward filtering, backward simulation
# ---------------------------------------------------------------------------


def _predicted_means(f, xf, u, tvec, p):
    """``f(xf[t, n], u[t], p, tvec[t])`` for every step and particle."""
    vm = torch.func.vmap
    return vm(vm(lambda xn, ut, tt: f(xn, ut, p, tt), in_dims=(0, None, None)),
              in_dims=(0, 0, 0))(xf, u, tvec)


def _gumbel(generator, shape, like: torch.Tensor) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, dtype=like.dtype,
                   device=like.device)
    return -torch.log(-torch.log(u.clamp_(min=torch.finfo(like.dtype).tiny)))


def _ffbs_scan(pf, xf, wf, u, xb_T, p, gumbel):
    """The backward pass as a reversed loop of (M × N) weight matrices
    and Gumbel-max draws (``gumbel(t)`` gives step t's [M, N] noise):
    the JAX package's XLA scan."""
    from .ops.mvnormal import MvNormal

    T, N, nx = xf.shape
    M = xb_T.shape[0]
    Ts = getattr(pf, "Ts", 1.0)
    f, df = pf.dynamics, pf.dynamics_density
    gaussian = isinstance(df, MvNormal)
    if gaussian:
        Sinv, mu = torch.linalg.inv(df.cov), df.mean
    xb = [xb_T]
    for t in range(T - 2, -1, -1):
        xpred = torch.func.vmap(lambda xn: f(xn, u[t], p, t * Ts))(xf[t])
        if gaussian:
            # the quadratic form expanded into one [M, nx] x [nx, N]
            # product, both sides centred on the predicted mean (it is
            # shift-invariant) against cancellation far from the origin
            shift = xpred.mean(0)
            db = xb[-1] - mu - shift
            dp = xpred - shift
            cm = torch.einsum("mi,ij,mj->m", db, Sinv, db)
            cn = torch.einsum("ni,ij,nj->n", dp, Sinv, dp)
            logp = -0.5 * (cm[:, None] + cn[None, :]) + (db @ Sinv) @ dp.mT
        else:
            diff = xb[-1][:, None, :] - xpred[None, :, :]
            logp = df.logpdf(diff.reshape(M * N, nx)).reshape(M, N)
        i = torch.argmax(wf[t][None, :] + logp + gumbel(t), -1)
        xb.append(xf[t][i])
    return torch.stack(xb[::-1])


def ffbs_smooth(pf, sol, M: int, generator: Optional[torch.Generator] = None,
                u=None, y=None, p=None, backend: str = "auto"):
    """Forward-filtering backward-simulation particle smoother.

    The terminal states are ``M`` draws from the last filtered cloud by
    the filter's resampling strategy; each earlier step draws, for every
    trajectory, a forward particle with probability proportional to its
    weight times the dynamics density of the trajectory's next state.

    ``backend``: ``"auto"`` runs the whole backward pass as kernel J
    (kernels/ffbs.py) when it admits the call (a Gaussian dynamics
    density, nx <= 8, float32 CUDA particles) and the plain loop
    otherwise; ``"kernel"`` raises where J does not admit the call;
    ``"plain"`` always runs the loop.  J draws its noise from Philox keyed
    by a seed drawn from ``generator``, so its draws differ from the
    loop's while being distributed alike.

    Returns ``(xb, ll)`` with ``xb`` of shape [T, M, nx].
    """
    from .kernels.ffbs import ffbs_backward, ffbs_kernel_supported
    from .ops.resample import resample
    from .routing import _needs_grad, _record, seed_from_generator

    if backend not in FFBS_BACKENDS:
        raise ValueError(f"backend must be one of {FFBS_BACKENDS}, got "
                         f"{backend!r}")
    xf, wf = sol.x, sol.w
    T, N, nx = xf.shape
    u = sol.u if u is None else _as_u_seq(u, T, xf.dtype, xf.device)
    p = getattr(pf, "p", None) if p is None else p
    df = pf.dynamics_density
    j = resample(sol.we[-1], generator, M,
                 strategy=getattr(pf, "resampling_strategy", "systematic"))
    xb_T = xf[-1][j]
    if backend != "plain":
        ok = ffbs_kernel_supported(df, nx, xf) and (
            backend == "kernel" or not _needs_grad(pf, sol, xb_T, u, p))
        if backend == "kernel" and not ok:
            raise ValueError(
                "ffbs backend='kernel' needs a Gaussian dynamics density, "
                f"nx <= 8 and float32 CUDA particles (got nx={nx}, "
                f"{xf.dtype} on {xf.device}, density "
                f"{type(df).__name__})")
        if ok:
            tvec = torch.arange(T - 1, dtype=xf.dtype, device=xf.device) \
                * getattr(pf, "Ts", 1.0)
            xpred = _predicted_means(pf.dynamics, xf[:-1], u[:-1], tvec, p)
            xb = ffbs_backward(xpred, wf[:-1], xf[:-1], xb_T, df.chol(),
                               df.mean, seed_from_generator(generator))
            _record("smooth", "cuda_ffbs_kernel")
            return xb, sol.ll
    xb = _ffbs_scan(pf, xf, wf, u, xb_T, p,
                    lambda t: _gumbel(generator, (M, N), xf))
    _record("smooth", "ffbs_plain")
    return xb, sol.ll


def smoothed_mean(xb: torch.Tensor) -> torch.Tensor:
    """Mean of smoothed trajectories ([T, M, nx] → [T, nx])."""
    return xb.mean(-2)


def smoothed_cov(xb: torch.Tensor) -> torch.Tensor:
    """Per-step covariance of smoothed trajectories ([T, M, nx] →
    [T, nx, nx])."""
    d = xb - smoothed_mean(xb)[..., None, :]
    return torch.einsum("...mi,...mj->...ij", d, d) / (xb.shape[-2] - 1)


def smoothed_trajs(xb: torch.Tensor) -> torch.Tensor:
    """Trajectories reordered to (nx, M, T), as the reference helper."""
    return xb.permute(2, 1, 0)
