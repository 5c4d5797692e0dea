"""Parameter estimation: prediction-error residuals, maximum-likelihood and
MAP covariance tuning, PMMH (counterpart of ``paramest.py``).

- :func:`prediction_errors`: whitened residuals, with the log-determinant
  residual, from the sequential recursion; differentiable by autograd and
  by ``torch.func``;
- :func:`log_likelihood_fun`, :func:`metropolis` and
  :func:`metropolis_parallel` (also with its chains split over the ranks
  of a ``torch.distributed`` mesh): particle marginal Metropolis–Hastings.  A
  ``torch.Generator`` stands where the JAX package takes a key, and the
  chain is a Python loop: each ``loglik`` inside it takes the verb's own
  route (kernel A for a particle filter on the card, kernel H or K for a
  Kalman filter);
- :func:`triangular`, :func:`invtriangular`, :func:`reconstruct_filter`;
- :func:`autotune_covariances`: Levenberg–Marquardt on the whitened
  residuals, the Jacobian by ``torch.func.jacrev`` through the filter's
  recursion.

A non-finite log-likelihood maps to -inf, so PMMH rejects the proposal.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence

import torch

from .ops.linalg import tri_solve
from .ops.mvnormal import MvNormal
from .trajectory import _as_u_seq, loglik

_LOG2PI = 1.8378770664093453


# ---------------------------------------------------------------------------
# Triangular covariance parametrization
# ---------------------------------------------------------------------------


def triangular(x: torch.Tensor) -> torch.Tensor:
    """A vector of n(n+1)/2 parameters -> the upper-triangular [n, n]
    matrix, filled row by row."""
    x = torch.as_tensor(x)
    m = x.shape[-1]
    n = round((-1 + math.sqrt(1 + 8 * m)) / 2)
    r, c = torch.triu_indices(n, n, device=x.device)
    return x.new_zeros((n, n)).index_put((r, c), x)


def invtriangular(T: torch.Tensor) -> torch.Tensor:
    """The upper triangle of ``T`` as a vector, row by row (the inverse
    of :func:`triangular`)."""
    T = torch.as_tensor(T)
    r, c = torch.triu_indices(T.shape[-1], T.shape[-1], device=T.device)
    return T[r, c]


def reconstruct_filter(f, R1, R2, x0=None):
    """A filter of the same kind with ``R1``, ``R2`` and, if given, the
    initial mean ``x0`` replaced: a ``replace`` of the filter's fields.
    A UKF or EKF keeps R2 in its measurement model."""
    d0 = f.d0 if x0 is None else MvNormal(torch.as_tensor(x0), f.d0.cov)
    names = {fl.name for fl in dataclasses.fields(f)}
    updates = {"d0": d0}
    if "R1" in names:
        updates["R1"] = torch.as_tensor(R1)
    if "R2" in names:
        updates["R2"] = torch.as_tensor(R2)
        return f.replace(**updates)
    mm = f.measurement_model.replace(R2=torch.as_tensor(R2))
    return f.replace(measurement_model=mm, **updates)


# ---------------------------------------------------------------------------
# Prediction-error residuals
# ---------------------------------------------------------------------------


def prediction_errors(f, u, y, p=None, lam=1.0, *, loglik: bool = False,
                      offset: float = 0.0) -> torch.Tensor:
    """Stacked per-step residuals for Gauss-Newton optimization.

    - ``loglik=False``: ``sqrt(λ)·e_t`` a step (λ a scalar, a vector or a
      matrix) -> a flat ``[T·ny]`` vector.
    - ``loglik=True``: the whitened residuals ``L⁻¹e/√2`` and one scalar
      ``sqrt(½(logdet S + ny·log 2π) + offset)`` a step -> ``[T·(ny+1)]``,
      so that ``‖res‖² = −loglik + T·offset``.

    Runs the sequential recursion (``last_route("prediction_errors")`` is
    ``"sequential"``); a negative square-root argument gives NaN residuals
    (raise ``offset``).
    """
    from .routing import _record

    T = y.shape[0]
    u_seq = _as_u_seq(u, T, y.dtype, y.device)
    p = getattr(f, "p", None) if p is None else p
    W = torch.sqrt(torch.as_tensor(lam, dtype=y.dtype, device=y.device))
    state = f.init()
    res = []
    for k in range(T):
        state, info = f.update(state, u_seq[k], y[k], p, k * f.Ts)
        if loglik:
            ny = y.shape[-1]
            r = tri_solve(info.Schol, info.e[:, None], lower=True)[:, 0]
            r = r / math.sqrt(2.0)
            logdet = 2.0 * torch.log(torch.diagonal(info.Schol)).sum()
            c = 0.5 * (logdet + ny * _LOG2PI) + offset
            res.append(torch.cat([r, torch.sqrt(c)[None]]))
        else:
            res.append(W * info.e if W.ndim < 2 else W @ info.e)
    _record("prediction_errors", "sequential", last=False)
    return torch.stack(res).reshape(-1)


# ---------------------------------------------------------------------------
# PMMH
# ---------------------------------------------------------------------------


def naive_sampler(theta0, scale: float = 0.1):
    """Gaussian random-walk proposal with per-component standard deviation
    ``scale·|θ₀|``: ``draw(theta, generator)``."""
    theta0 = torch.as_tensor(theta0)
    if bool((theta0 == 0).any()):
        raise ValueError("naive_sampler requires a nonzero initial "
                         "parameter vector")
    std = scale * theta0.abs()

    def draw(theta, generator=None):
        z = torch.randn(theta.shape, generator=generator, dtype=theta.dtype,
                        device=_gen_device(generator, theta))
        return theta + std.to(theta.device) * z.to(theta.device)

    return draw


def _gen_device(generator, like):
    return generator.device if generator is not None else like.device


def log_likelihood_fun(filter_from_parameters: Callable, priors: Sequence,
                       u, y, p=None, **kwargs) -> Callable:
    """``θ -> log p(y|θ) + log p(θ)``: ``filter_from_parameters(θ)`` builds
    a filter, ``priors`` holds one density with ``logpdf`` a parameter.
    The returned ``ll(theta, generator=None)`` passes a generator to the
    filter's ``loglik`` (a particle filter's draws) and maps non-finite
    values to -inf."""

    def ll(theta, generator=None):
        theta = torch.as_tensor(theta)
        lp = sum(torch.as_tensor(priors[i].logpdf(theta[i])).sum()
                 for i in range(len(priors)))
        f = filter_from_parameters(theta)
        if generator is not None:
            lly = loglik(f, u, y, p, generator=generator, **kwargs)
        else:
            lly = loglik(f, u, y, p, **kwargs)
        total = lp + lly
        return torch.where(torch.isfinite(total), total,
                           torch.full_like(total, -math.inf))

    return ll


def metropolis(ll: Callable, R: int, theta0, draw=None,
               generator: Optional[torch.Generator] = None,
               ll_takes_key: bool = False, *, uniforms=None):
    """A marginal Metropolis–Hastings chain of ``R`` samples (the first is
    ``theta0``) as a Python loop.  Each iteration draws the proposal
    (``draw(theta, generator)``), then, with ``ll_takes_key``, passes the
    generator to ``ll`` (a particle filter's likelihood: PMMH proper),
    then draws the acceptance uniform.  ``uniforms`` ([R − 1]) replaces
    those draws with pre-drawn ones.  Returns ``(thetas [R, nθ],
    lls [R])`` on ``theta0``'s device, each in its own dtype."""
    theta = torch.as_tensor(theta0)
    draw_fn = naive_sampler(theta) if draw is None else draw

    def value(v):
        return torch.as_tensor(v).to(theta.device)

    llv = value(ll(theta, generator) if ll_takes_key else ll(theta))
    thetas, lls = [theta], [llv]
    for i in range(R - 1):
        prop = draw_fn(theta, generator)
        llp = value(ll(prop, generator) if ll_takes_key else ll(prop))
        if uniforms is None:
            uni = torch.rand((), generator=generator, dtype=theta.dtype,
                             device=_gen_device(generator, theta))
        else:
            uni = torch.as_tensor(uniforms[i], dtype=theta.dtype)
        accept = torch.log(uni.to(theta.device)) < llp - llv
        theta = torch.where(accept, prop, theta)
        llv = torch.where(accept, llp, llv)
        thetas.append(theta)
        lls.append(llv)
    return torch.stack(thetas), torch.stack(lls)


def metropolis_parallel(burnin: int, ll: Callable, R: int, theta0,
                        draw=None, generator: Optional[torch.Generator] = None,
                        n_chains: int = 8, ll_takes_key: bool = False,
                        mesh=None, axis_name: Optional[str] = None):
    """``n_chains`` independent chains of :func:`metropolis`, each with a
    generator seeded from a draw of ``generator``; the samples after
    ``burnin`` of every chain, concatenated to ``[(R − burnin)·n_chains,
    nθ + 1]`` with the log-likelihood in the last column.

    The chains are not run under ``torch.func.vmap``: inside a transform
    every ``loglik`` would take the sequential route.  With ``mesh`` (a
    ``parallel.sharded.Mesh``; ``axis_name`` has no role, the mesh is its
    group) every rank calls this with a generator seeded alike: rank r
    runs chains r·k … r·k + k − 1 of the same seeds (k = n_chains / mesh
    size), the blocks are all-gathered, and every rank returns the whole
    array, equal to the meshless call's."""
    draw = naive_sampler(theta0) if draw is None else draw
    dev = generator.device if generator is not None else "cpu"
    seeds = torch.randint(0, 2**62, (n_chains,), generator=generator,
                          device=dev).tolist()
    size, rank = (1, 0) if mesh is None else (mesh.size, mesh.rank)
    if n_chains % size:
        raise ValueError(f"n_chains={n_chains} must be divisible by the "
                         f"mesh size {size}")
    k = n_chains // size
    out = []
    for seed in seeds[rank * k:(rank + 1) * k]:
        g = torch.Generator(device=dev).manual_seed(int(seed))
        thetas, lls = metropolis(ll, R, theta0, draw, generator=g,
                                 ll_takes_key=ll_takes_key)
        out.append(torch.cat([thetas[burnin:], lls[burnin:, None]], -1))
    block = torch.cat(out, 0)
    if mesh is None:
        return block
    from .parallel.sharded import _all_gather

    parts = _all_gather(block.to(mesh.device), mesh)
    return parts.reshape(-1, block.shape[-1]).to(block.device)


# ---------------------------------------------------------------------------
# Covariance autotuning
# ---------------------------------------------------------------------------


def _iw_neglogprior(Sigma, v, Psi):
    """Inverse-Wishart negative log-density up to a constant:
    ``(v + n + 1)/2 · logdet Σ + ½ tr(Ψ Σ⁻¹)``.  It enters the
    Gauss-Newton step exactly, through its gradient and Hessian."""
    n = Sigma.shape[-1]
    L = torch.linalg.cholesky(Sigma)
    logdet = 2.0 * torch.log(torch.diagonal(L)).sum()
    tr = torch.trace(torch.cholesky_solve(Psi, L))
    return (v + n + 1) / 2.0 * logdet + 0.5 * tr


def autotune_covariances(f, u, y, p=None, *, diagonal: bool = True,
                         optimize_x0: bool = False, offset: float = 0.0,
                         iters: int = 50, lm_lambda0: float = 1e-2,
                         v_R1: Optional[float] = None,
                         v_R2: Optional[float] = None,
                         verbose: bool = False):
    """Maximum-likelihood (or MAP) tuning of ``(R1, R2[, x0])`` by
    Levenberg–Marquardt on the whitened prediction-error residuals.

    - ``diagonal=True``: the log-diagonals are optimized (positive for
      free); otherwise the upper-triangular Cholesky factors (R = TᵀT).
    - ``v_R1``/``v_R2``: the Inverse-Wishart prior's degrees of freedom for
      MAP estimation (prior mean: the filter's current covariances).
    - The loop runs at most ``iters`` iterations; the residuals' Jacobian
      is ``torch.func.jacrev`` through the recursion, so every step takes
      the sequential route.  The JAX package takes ``jax.jacfwd``; the
      Jacobian is the same, and PyTorch's forward mode runs elementwise
      tangents through Python reference decompositions: 1.7x slower than
      reverse mode on an H100, 1.3x on its host, at T = 1000
      (``scripts/torch_stage_breakdown.py paramest``).

    Returns ``(f_opt, info)``; ``info`` holds ``R1``, ``R2``, ``x0``,
    ``cost``, ``theta`` and ``neg_loglik``.
    """
    R1_0 = torch.as_tensor(f.R1)
    R2_0 = torch.as_tensor(f.R2)
    x0_0 = f.d0.mean
    nw, ny = R1_0.shape[-1], R2_0.shape[-1]

    if v_R1 is not None and v_R1 <= nw - 1:
        raise ValueError(f"v_R1 must be > nw-1 = {nw - 1}")
    if v_R2 is not None and v_R2 <= ny - 1:
        raise ValueError(f"v_R2 must be > ny-1 = {ny - 1}")
    Psi1 = (v_R1 - nw - 1) * R1_0 if v_R1 is not None else None
    Psi2 = (v_R2 - ny - 1) * R2_0 if v_R2 is not None else None

    if diagonal:
        th_R1 = torch.log(torch.diagonal(R1_0))
        th_R2 = torch.log(torch.diagonal(R2_0))

        def unpack(th):
            return torch.diag(torch.exp(th))
    else:
        th_R1 = invtriangular(torch.linalg.cholesky(R1_0).T)
        th_R2 = invtriangular(torch.linalg.cholesky(R2_0).T)

        def unpack(th):
            T_ = triangular(th)
            return T_.T @ T_

    n1, n2 = th_R1.shape[0], th_R2.shape[0]
    theta0 = torch.cat([th_R1, th_R2] + ([x0_0] if optimize_x0 else []))

    def build(theta):
        R1 = unpack(theta[:n1])
        R2 = unpack(theta[n1:n1 + n2])
        x0 = theta[n1 + n2:] if optimize_x0 else None
        return reconstruct_filter(f, R1, R2, x0), R1, R2

    def residuals(theta):
        return prediction_errors(build(theta)[0], u, y, p, loglik=True,
                                 offset=offset)

    def residuals_aux(theta):
        r = residuals(theta)
        return r, r

    def prior(theta):
        _, R1, R2 = build(theta)
        pe = theta.new_zeros(())
        if Psi1 is not None:
            pe = pe + _iw_neglogprior(R1, v_R1, Psi1)
        if Psi2 is not None:
            pe = pe + _iw_neglogprior(R2, v_R2, Psi2)
        return pe

    def cost(theta):
        return float(0.5 * (residuals(theta) ** 2).sum() + prior(theta))

    has_prior = Psi1 is not None or Psi2 is not None
    theta = theta0
    lam = lm_lambda0
    c = cost(theta)
    for it in range(iters):
        J, r = torch.func.jacrev(residuals_aux, has_aux=True)(theta)
        JtJ = J.T @ J
        g = J.T @ r
        if has_prior:
            g = g + torch.func.grad(prior)(theta)
            JtJ = JtJ + torch.func.hessian(prior)(theta)
        damp = torch.diag(torch.clamp(torch.diagonal(JtJ).abs(), min=1e-12))
        step = torch.linalg.solve(JtJ + lam * damp, g)
        cand = theta - step
        c_new = cost(cand)
        if math.isfinite(c_new) and c_new < c:
            theta, c = cand, c_new
            lam = max(lam / 3.0, 1e-10)
        else:
            lam = min(lam * 5.0, 1e8)
        if verbose:
            print(f"iter {it:3d}  cost {c:.6e}  lambda {lam:.1e}")
        if float(step.abs().max()) < 1e-10:
            break

    f_opt, R1, R2 = build(theta)
    ssq = float((residuals(theta) ** 2).sum())  # = -loglik + T·offset
    info = {
        "R1": R1,
        "R2": R2,
        "x0": theta[n1 + n2:] if optimize_x0 else x0_0,
        "cost": c,
        "theta": theta,
        "neg_loglik": ssq - y.shape[0] * offset,
    }
    return f_opt, info
