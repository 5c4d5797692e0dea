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


def forward_trajectory(f, u, y, p=None, *, pre_correct_cb=None,
                       post_correct_cb=None, pre_predict_cb=None,
                       post_predict_cb=None, method: str = "auto",
                       **kwargs):
    """Run a filter over inputs ``u[T, nu]`` and measurements ``y[T, ny]``.

    Kalman-family filters (KF, UKF, EKF) return a
    :class:`KalmanFilteringSolution`: through the temporal-parallel path
    (``parallel/temporal.py``, kernel K on CUDA float32) or a whole-scan
    kernel (kernels/ukf_scan.py) when ``routing`` admits it — see
    ``routing.py`` for ``method=`` — else the sequential recursion.
    A filter with a ``forward_trajectory`` of its own (the particle
    filters, the EnKF, IMM, RBPF and UIKF) runs it, and is handed the
    callbacks, as in the JAX package.
    ``last_route("forward_trajectory")`` names the path taken.

    The four per-step callbacks (a call with any of them, or with a
    measurement model ``mm=``, takes the sequential route):

    - ``pre_correct_cb(f, state, u, y, p, t)`` -> an R2 for this step, or
      None;
    - ``post_correct_cb(f, state, info, u, y, p, t)`` -> ``(state,
      extra)`` or None; the extras are stacked into ``sol.extra``;
    - ``pre_predict_cb(f, state, u, y, p, t, info)`` -> an R1, or None;
    - ``post_predict_cb(f, state, u, y, p, t)`` -> a state, or None.
    """
    from .routing import _check_method, _record, route_forward_trajectory

    _check_method(method)
    cbs = dict(pre_correct_cb=pre_correct_cb,
               post_correct_cb=post_correct_cb,
               pre_predict_cb=pre_predict_cb,
               post_predict_cb=post_predict_cb)
    has_cb = any(cb is not None for cb in cbs.values())
    if hasattr(f, "forward_trajectory"):
        return f.forward_trajectory(u, y, p, **cbs, **kwargs)
    if not has_cb and kwargs.get("mm") is None:
        sol = route_forward_trajectory(f, u, y, p, method)
        if sol is not None:
            return sol
    else:
        _record("forward_trajectory", "sequential")
    return kalman_forward_trajectory(f, u, y, p, **cbs,
                                     mm=kwargs.get("mm")).replace(
        route="sequential")


def _stack_tree(vals):
    """Stack a list of per-step values: tensors, tuples or lists of them,
    or all None (-> None)."""
    if all(v is None for v in vals):
        return None
    if isinstance(vals[0], (tuple, list)):
        return type(vals[0])(_stack_tree(list(c)) for c in zip(*vals))
    return torch.stack([torch.as_tensor(v) for v in vals])


def kalman_forward_trajectory(kf, u, y, p=None, *, pre_correct_cb=None,
                              post_correct_cb=None, pre_predict_cb=None,
                              post_predict_cb=None, mm=None
                              ) -> KalmanFilteringSolution:
    """Step order as in the reference: save prediction → correct → save
    filtered → predict, with the per-step callbacks of
    :func:`forward_trajectory` and an optional measurement model ``mm``
    in place of the filter's own."""
    T = y.shape[0]
    u_seq = _as_u_seq(u, T, y.dtype, y.device)
    state = kf.init()
    xs, Rs, xts, Rts, lls, es, Ss, Ks, extras = ([] for _ in range(9))
    for k in range(T):
        tk = k * kf.Ts
        uk, yk = u_seq[k], y[k]
        xs.append(kf.state(state))
        Rs.append(kf.covariance(state))
        R2 = pre_correct_cb(kf, state, uk, yk, p, tk) if pre_correct_cb \
            else None
        state, info = kf.correct(state, uk, yk, p, tk, R2=R2, mm=mm)
        extra = None
        if post_correct_cb:
            out = post_correct_cb(kf, state, info, uk, yk, p, tk)
            if out is not None:
                state, extra = out
        extras.append(extra)
        xts.append(kf.state(state))
        Rts.append(kf.covariance(state))
        lls.append(info.ll)
        es.append(info.e)
        Ss.append(info.S)
        Ks.append(info.K)
        R1 = pre_predict_cb(kf, state, uk, yk, p, tk, info) \
            if pre_predict_cb else None
        state = kf.predict(state, uk, p, tk, R1=R1)
        if post_predict_cb:
            out = post_predict_cb(kf, state, uk, yk, p, tk)
            if out is not None:
                state = out
    xt = torch.stack(xts)
    e = torch.stack(es)
    ok = torch.isfinite(xt).all(-1) & torch.isfinite(e).all(-1)
    return KalmanFilteringSolution(
        u=u_seq, y=y, x=torch.stack(xs), xt=xt, R=torch.stack(Rs),
        Rt=torch.stack(Rts), ll=torch.stack(lls).sum(), e=e,
        K=torch.stack(Ks), S=torch.stack(Ss), extra=_stack_tree(extras),
        t=torch.arange(T, dtype=y.dtype, device=y.device) * kf.Ts, ok=ok)


def loglik(f, u, y, p=None, method: str = "auto", **kwargs):
    """Total log-likelihood of the data.  Particle filters route through
    ``routing.route_pf_loglik`` (kernel A on CUDA tensors); Kalman-family
    filters through ``routing.route_kalman_loglik`` (the temporal-parallel
    path or a whole-scan kernel, as for :func:`forward_trajectory`) or the
    sequential recursion.  Any other filter with a ``loglik`` of its own
    (the EnKF, IMM, RBPF) is called without ``method`` and records
    ``"sequential"``, as the JAX package does."""
    if hasattr(f, "loglik"):
        from .filters.particle import _ParticleCommon

        if isinstance(f, _ParticleCommon):
            return f.loglik(u, y, p, method=method, **kwargs)
        from .routing import _check_method, _record

        _check_method(method)
        _record("loglik", "sequential")
        return f.loglik(u, y, p, **kwargs)
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


def sse(f, u, y, p=None, lam=1.0) -> torch.Tensor:
    """Sum of squared prediction errors ``Σ eᵀ λ e`` (``lam`` a scalar, a
    vector of weights or a matrix)."""
    T = y.shape[0]
    u_seq = _as_u_seq(u, T, y.dtype, y.device)
    lam = torch.as_tensor(lam, dtype=y.dtype, device=y.device)
    state = f.init()
    total = y.new_zeros(())
    for k in range(T):
        state, info = f.update(state, u_seq[k], y[k], p, k * f.Ts)
        e = info.e
        w = lam * e if lam.ndim < 2 else lam @ e
        total = total + (e * w).sum()
    return total


def loglik_x(f, u, y, x, p=None) -> torch.Tensor:
    """Log-likelihood of a state sequence ``x [T, nx]`` under a
    Kalman-family filter: ``Σ logpdf(N(0, R(t+1|t)), x_t − x̂(t|t−1))``
    over t = 0 .. T−2, the covariance taken after the step's predict, as
    in the reference."""
    from .ops.mvnormal import mvnormal_logpdf_cov

    T = y.shape[0]
    u_seq = _as_u_seq(u, T, y.dtype, y.device)
    state = f.init()
    total = y.new_zeros(())
    for k in range(T - 1):
        tk = k * f.Ts
        xe = x[k] - f.state(state)
        state, _ = f.correct(state, u_seq[k], y[k], p, tk)
        state = f.predict(state, u_seq[k], p, tk)
        total = total + mvnormal_logpdf_cov(xe, torch.zeros_like(xe),
                                            f.covariance(state))
    return total


def simulate(f, u, generator: Optional[torch.Generator], p=None, *,
             du=None, dynamics_noise: bool = True,
             measurement_noise: bool = True, sample_initial: bool = False):
    """Draw one trajectory from the filter's generative model:
    ``x, u, y = simulate(f, u, generator)`` with ``u`` of shape
    [T, nu], or ``simulate(f, T, generator, du=input_density)`` with the
    inputs drawn from ``du`` first.  Returns stacked ``x [T, nx]``,
    ``u``, ``y [T, ny]``.  A filter whose measurement model carries an
    R12 cross-covariance draws the joint noise (``simulate_correlated``).
    """
    if isinstance(u, int):
        if du is None:
            raise ValueError("provide du (input density) when simulating T "
                             "steps")
        u = du.sample(generator, (u,))
    if (hasattr(f, "simulate_correlated")
            and getattr(getattr(f, "measurement_model", None), "R12",
                        None) is not None
            and dynamics_noise and measurement_noise):
        return f.simulate_correlated(u, generator, p,
                                     sample_initial=sample_initial)
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


def simulate_ensemble(f, u, generator: Optional[torch.Generator],
                      n_runs: int, p=None, **kwargs):
    """``n_runs`` trajectories of :func:`simulate`, drawn one after the
    other from ``generator``: ``(x [n_runs, T, nx], u, y [n_runs, T,
    ny])``.  With an input tensor every run shares it and ``u`` is
    returned as it is; with the integer-T form and ``du`` each run draws
    its own inputs, and ``u`` is the stacked ``[n_runs, T, nu]``."""
    runs = [simulate(f, u, generator, p, **kwargs) for _ in range(n_runs)]
    xs, us, ys = (torch.stack(r) for r in zip(*runs))
    return xs, (us if isinstance(u, int) else runs[0][1]), ys


def rollout(dyn, x0, u, p=None, Ts: float = 1.0) -> torch.Tensor:
    """Open-loop rollout of ``dyn(x, u, p, t)``: ``[T + 1, nx]``, ``x0``
    followed by the propagated states (step k's time is (k + 1) Ts)."""
    u = torch.as_tensor(u)
    x = torch.as_tensor(x0)
    xs = [x]
    for k in range(u.shape[0]):
        x = dyn(x, u[k], p, (k + 1) * Ts)
        xs.append(x)
    return torch.stack(xs)


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


def weighted_quantile(x: torch.Tensor, we: torch.Tensor, q) -> torch.Tensor:
    """Weighted quantile ``q`` per dimension by inverting the weighted
    CDF: ``x`` [..., N, nx], ``we`` [..., N] -> [..., nx]."""
    order = torch.argsort(x, dim=-2, stable=True)
    xs = torch.take_along_dim(x, order, dim=-2)
    ws = torch.take_along_dim(we[..., None].expand_as(x), order, dim=-2)
    cdf = torch.cumsum(ws, dim=-2)
    cdf = cdf / cdf[..., -1:, :]
    idx = (cdf < torch.as_tensor(q, dtype=cdf.dtype, device=cdf.device)
           ).sum(-2).clamp(0, x.shape[-2] - 1)
    return torch.take_along_dim(xs, idx[..., None, :], dim=-2)[..., 0, :]


def mean_trajectory(x, we=None, y=None, *, p=None,
                    generator: Optional[torch.Generator] = None,
                    method: str = "auto") -> torch.Tensor:
    """The weighted mean along a particle trajectory, in two forms:

    - ``mean_trajectory(x [T, N, nx], we [T, N])`` reduces a stored
      solution;
    - ``mean_trajectory(pf, u, y, generator=g)`` runs the filter and
      returns its filtered means ``[T, nx]``: on CUDA tensors an admitted
      bootstrap PF runs kernel A in its moments mode (the cloud never
      leaves the card, only the means are written;
      ``routing.route_pf_mean_trajectory``), otherwise
      ``forward_trajectory`` and the weighted mean.
    """
    if not hasattr(x, "forward_trajectory"):
        return weighted_mean(x, we)
    from .routing import route_pf_mean_trajectory

    f, u = x, we
    means = route_pf_mean_trajectory(f, u, y, p, generator, method)
    if means is not None:
        return means
    sol = f.forward_trajectory(u, y, p, generator=generator)
    return weighted_mean(sol.x, sol.we)


def mode_trajectory(x: torch.Tensor, we: torch.Tensor) -> torch.Tensor:
    """The highest-weight particle of every step: [T, N, nx] -> [T, nx]."""
    idx = torch.argmax(we, dim=-1)
    return torch.take_along_dim(x, idx[..., None, None], dim=-2)[..., 0, :]
