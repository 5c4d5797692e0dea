"""Batch filtering along a trajectory (counterpart of ``trajectory.py``).

The JAX package's ``lax.scan`` becomes a Python loop over time; the
solution fields are stacked at the end.  Particle filters bring their
own ``forward_trajectory``/``loglik``.
"""
from __future__ import annotations

from typing import Optional

import torch

from .utils.solutions import KalmanFilteringSolution


def _as_u_seq(u, T: int, dtype, device=None) -> torch.Tensor:
    """None -> [T, 0]; a constant [nu] input is tiled to [T, nu]; a
    [T, nu] tensor passes through."""
    if u is None:
        return torch.zeros((T, 0), dtype=dtype, device=device)
    u = torch.as_tensor(u, device=device)
    if u.ndim == 1:
        return u.reshape(1, -1).expand(T, -1)
    return u


def forward_trajectory(f, u, y, p=None, *, method: str = "auto", **kwargs):
    """Run a filter over inputs ``u[T, nu]`` and measurements ``y[T, ny]``.

    Kalman-family filters (KF, UKF, EKF) return a
    :class:`KalmanFilteringSolution`: through the temporal-parallel path
    (``parallel/temporal.py``, kernel K on CUDA float32) or a whole-scan
    kernel (kernels/ukf_scan.py) when ``routing`` admits it — see
    ``routing.py`` for ``method=`` — else the sequential recursion.
    Particle filters return a
    ``ParticleFilteringSolution`` from their own method.
    ``last_route("forward_trajectory")`` names the path taken.
    """
    from .routing import _check_method, route_forward_trajectory

    _check_method(method)
    if hasattr(f, "forward_trajectory"):
        return f.forward_trajectory(u, y, p, **kwargs)
    sol = route_forward_trajectory(f, u, y, p, method)
    if sol is not None:
        return sol
    return kalman_forward_trajectory(f, u, y, p).replace(route="sequential")


def kalman_forward_trajectory(kf, u, y, p=None) -> KalmanFilteringSolution:
    """Step order as in the reference: save prediction → correct → save
    filtered → predict."""
    T = y.shape[0]
    u_seq = _as_u_seq(u, T, y.dtype, y.device)
    state = kf.init()
    xs, Rs, xts, Rts, lls, es, Ss, Ks = ([] for _ in range(8))
    for k in range(T):
        tk = k * kf.Ts
        xs.append(state.x)
        Rs.append(state.R)
        state, info = kf.correct(state, u_seq[k], y[k], p, tk)
        xts.append(state.x)
        Rts.append(state.R)
        lls.append(info.ll)
        es.append(info.e)
        Ss.append(info.S)
        Ks.append(info.K)
        state = kf.predict(state, u_seq[k], p, tk)
    xt = torch.stack(xts)
    e = torch.stack(es)
    ok = torch.isfinite(xt).all(-1) & torch.isfinite(e).all(-1)
    return KalmanFilteringSolution(
        u=u_seq, y=y, x=torch.stack(xs), xt=xt, R=torch.stack(Rs),
        Rt=torch.stack(Rts), ll=torch.stack(lls).sum(), e=e,
        K=torch.stack(Ks), S=torch.stack(Ss),
        t=torch.arange(T, dtype=y.dtype, device=y.device) * kf.Ts, ok=ok)


def loglik(f, u, y, p=None, method: str = "auto", **kwargs):
    """Total log-likelihood of the data.  Particle filters route through
    ``routing.route_pf_loglik`` (kernel A on CUDA tensors); Kalman-family
    filters through ``routing.route_kalman_loglik`` (the temporal-parallel
    path or a whole-scan kernel, as for :func:`forward_trajectory`) or the
    sequential recursion."""
    if hasattr(f, "loglik"):
        return f.loglik(u, y, p, method=method, **kwargs)
    from .routing import route_kalman_loglik

    ll = route_kalman_loglik(f, u, y, p, method)
    if ll is not None:
        return ll
    T = y.shape[0]
    u_seq = _as_u_seq(u, T, y.dtype, y.device)
    state = f.init()
    ll = y.new_zeros(())
    for k in range(T):
        state, info = f.update(state, u_seq[k], y[k], p, k * f.Ts)
        ll = ll + info.ll
    return ll


def simulate(f, u, generator: Optional[torch.Generator], p=None, *,
             dynamics_noise: bool = True, measurement_noise: bool = True,
             sample_initial: bool = False):
    """Draw one trajectory from the filter's generative model:
    ``x, u, y = simulate(f, u, generator)`` with ``u`` of shape
    [T, nu].  Returns stacked ``x [T, nx]``, ``u``, ``y [T, ny]``."""
    p = getattr(f, "p", None) if p is None else p
    u = torch.as_tensor(u)
    T = u.shape[0]
    Ts = getattr(f, "Ts", 1.0)
    x = f.sample_initial(generator, p, noise=sample_initial)
    xs, ys = [], []
    for k in range(T):
        tk = k * Ts
        ys.append(f.sample_measurement(generator, x, u[k], p, tk,
                                       noise=measurement_noise))
        xs.append(x)
        x = f.sample_state(generator, x, u[k], p, tk, noise=dynamics_noise)
    return torch.stack(xs), u, torch.stack(ys)


def weighted_mean(x: torch.Tensor, we: torch.Tensor) -> torch.Tensor:
    """Weighted mean over the particle axis: ``x`` [..., N, nx],
    ``we`` [..., N] -> [..., nx]."""
    return torch.einsum("...n,...nd->...d", we, x)


def weighted_cov(x: torch.Tensor, we: torch.Tensor) -> torch.Tensor:
    """Weighted (frequency-corrected) covariance per time step."""
    m = weighted_mean(x, we)
    d = x - m[..., None, :]
    cov = torch.einsum("...n,...ni,...nj->...ij", we, d, d)
    corr = 1.0 / (1.0 - torch.square(we).sum(-1))
    return cov * corr[..., None, None]
