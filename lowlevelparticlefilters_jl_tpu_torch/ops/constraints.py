"""Constraint handling for Gaussian state estimates (counterpart of
``ops/constraints.py``): the rank-1 equality projection onto an active
bound (``project_bound``) and truncated-Gaussian moment matching
(``truncated_moment_match``, with the scalar moments
``truncated_scalar_moments``).

Every case is computed and the result chosen with ``torch.where``, as in
the JAX package, so the functions batch under ``torch.func.vmap`` and
differentiate.
"""
from __future__ import annotations

import math

import torch

from .linalg import symmetrize_psd

_SQRT2 = 1.4142135623730951
_INV_SQRT_2PI = 0.3989422804014327


def _normpdf(z):
    return _INV_SQRT_2PI * torch.exp(-0.5 * z * z)


def _normcdf(z):
    """Φ(z) through erfc, stable in both tails."""
    return 0.5 * torch.special.erfc(-z / _SQRT2)


def _normccdf(z):
    """1 − Φ(z), stable for large z."""
    return 0.5 * torch.special.erfc(z / _SQRT2)


def _like(v, ref):
    return torch.as_tensor(v, dtype=ref.dtype, device=ref.device)


def truncated_scalar_moments(m, s, a, b, tol: float = 1e-12):
    """Mean and variance of N(m, s²) truncated to [a, b]: ``(m', s2',
    ok)``, ``ok`` False where the mass is numerically empty (the caller
    then projects onto a bound).  Infinite bounds take the one-sided
    Mills-ratio forms."""
    m = torch.as_tensor(m)
    s = _like(s, m)
    a, b = _like(a, m), _like(b, m)
    s_safe = torch.where(s > 0, s, torch.ones_like(s))
    lo_fin, hi_fin = torch.isfinite(a), torch.isfinite(b)
    # infinite bounds are cut out of the graph (inf·0 → NaN in the chain
    # rule otherwise); ±38σ is an exact 0/1 in float32 and float64
    BIG = 38.0
    a_f = torch.where(lo_fin, a, m - BIG * s_safe)
    b_f = torch.where(hi_fin, b, m + BIG * s_safe)
    alpha = torch.clamp((a_f - m) / s_safe, -BIG, BIG)
    beta = torch.clamp((b_f - m) / s_safe, -BIG, BIG)
    zero = torch.zeros_like(alpha)

    # one-sided lower [a, ∞): λ = φ(α) / (1 − Φ(α))
    lam_lo = _normpdf(alpha) / torch.clamp(_normccdf(alpha), min=tol)
    m_lo = m + s * lam_lo
    s2_lo = torch.clamp(s**2 * (1 - lam_lo * (lam_lo - alpha)), min=0.0)
    ok_lo = (m_lo >= a) & (m_lo <= b)

    # one-sided upper (−∞, b]
    lam_hi = _normpdf(beta) / torch.clamp(_normcdf(beta), min=tol)
    m_hi = m - s * lam_hi
    s2_hi = torch.clamp(s**2 * (1 - lam_hi * (lam_hi + beta)), min=0.0)

    # two-sided [a, b]
    pa = torch.where(lo_fin, _normpdf(alpha), zero)
    pb = torch.where(hi_fin, _normpdf(beta), zero)
    Fa = torch.where(lo_fin, _normcdf(alpha), zero)
    Fb = torch.where(hi_fin, _normcdf(beta), torch.ones_like(beta))
    Z = Fb - Fa
    Zs = torch.clamp(Z, min=tol)
    mshift = (pa - pb) / Zs
    apa = torch.where(lo_fin, alpha * pa, zero)
    bpb = torch.where(hi_fin, beta * pb, zero)
    m_two = m + s * mshift
    s2_two = torch.clamp(s**2 * (1 + (apa - bpb) / Zs - mshift**2), min=0.0)
    ok_two = Z > tol

    one_lo = lo_fin & ~hi_fin
    one_hi = hi_fin & ~lo_fin
    m_out = torch.where(one_lo, m_lo, torch.where(one_hi, m_hi, m_two))
    s2_out = torch.where(one_lo, s2_lo, torch.where(one_hi, s2_hi, s2_two))
    ok = torch.where(one_lo, ok_lo, torch.where(one_hi, torch.ones_like(
        ok_two), ok_two))
    # a degenerate scale or a collapsed interval is not ok
    ok = ok & (s > 0) & (a < b)
    m_out = torch.where(a >= b, torch.minimum(torch.maximum(m, a), b), m_out)
    return m_out, s2_out, ok


def _rank1_projection(x, C, idx: int, d):
    """Project (x, C) onto the hyperplane ``x[idx] = d``."""
    s2 = C[idx, idx]
    s2_safe = torch.where(s2 > 0, s2, torch.ones_like(s2))
    Ci = C[:, idx]
    K = Ci / s2_safe
    x_new = x - K * (x[idx] - d)
    C_new = C - torch.outer(K, Ci)
    degenerate = ~torch.isfinite(s2) | (s2 <= 0)
    onehot = torch.arange(x.shape[-1], device=x.device) == idx
    x_set = torch.where(onehot, d, x)
    x_new = torch.where(degenerate, x_set, x_new)
    C_new = torch.where(degenerate, C, symmetrize_psd(C_new))
    return x_new, C_new


def project_bound(mu, P, idx: int, lower=-math.inf, upper=math.inf,
                  tol: float = 1e-9):
    """Clamp ``x[idx]`` to [lower, upper] by a rank-1 equality projection;
    a feasible state passes through unchanged."""
    mu = torch.as_tensor(mu)
    P = torch.as_tensor(P)
    lower, upper = _like(lower, mu), _like(upper, mu)
    below = mu[idx] < lower - tol
    above = mu[idx] > upper + tol
    d = torch.where(below, lower, torch.where(above, upper, mu[idx]))
    x_proj, P_proj = _rank1_projection(mu, P, idx, d)
    active = below | above
    return torch.where(active, x_proj, mu), torch.where(active, P_proj, P)


def truncated_moment_match(mu, Sigma, idx: int, lower=-math.inf,
                           upper=math.inf, tol: float = 1e-12,
                           var_floor: float = 1e-12):
    """Enforce ``lower <= x[idx] <= upper`` by moment matching of the
    truncated marginal and the regression identity

        μ' = μ + A (m' − m),   Σ' = Σ + (s2' − s2) A Aᵀ,   A = Σ[:, idx] / s2;

    the rank-1 projection onto the nearest active bound where the
    feasible mass is numerically zero."""
    mu = torch.as_tensor(mu)
    Sigma = torch.as_tensor(Sigma)
    lower, upper = _like(lower, mu), _like(upper, mu)
    s2 = Sigma[idx, idx]
    s2_safe = torch.where(s2 > 0, s2, torch.ones_like(s2))
    m = mu[idx]
    s = torch.sqrt(s2_safe)
    mp, s2p, ok = truncated_scalar_moments(m, s, lower, upper, tol=tol)

    A = Sigma[:, idx] / s2_safe
    x_mm = mu + A * (mp - m)
    C_mm = symmetrize_psd(Sigma + (s2p - s2) * torch.outer(A, A),
                          eps=var_floor)

    # the fallback: the nearest active bound
    lo = torch.where(torch.isfinite(lower), lower, m)
    hi = torch.where(torch.isfinite(upper), upper, m)
    d = torch.where(m < lower - tol, lo,
                    torch.where(m > upper + tol, hi,
                                torch.where((m - lo).abs() < (hi - m).abs(),
                                            lo, hi)))
    x_fb, C_fb = _rank1_projection(mu, Sigma, idx, d)

    degenerate = ~torch.isfinite(s2) | (s2 <= 0)
    onehot = torch.arange(mu.shape[-1], device=mu.device) == idx
    x_deg = torch.where(onehot, torch.minimum(torch.maximum(m, lower),
                                              upper), mu)
    x_out = torch.where(degenerate, x_deg, torch.where(ok, x_mm, x_fb))
    C_out = torch.where(degenerate, Sigma, torch.where(ok, C_mm, C_fb))
    return x_out, C_out
