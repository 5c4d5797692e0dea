"""Statistical filter-validation numerics (counterpart of
``utils/diagnostics.py``).

The numbers behind ``validationplot`` (innovation RMS, NIS and its χ²
bounds, innovation autocorrelation and innovation-input
cross-correlation) and the weighted kernel density estimate: tensors in,
tensors out, on the device of the inputs (arrays go to the device of
the tensors among them, or to the card: ``kernels/_lib.as_tensors``).
The rendering lives in utils/plotting.py.  The χ² and normal quantiles
come from scipy.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..kernels._lib import as_tensors


def innovation_rms(e: torch.Tensor) -> torch.Tensor:
    """Per-output RMS of the innovation sequence ``e`` [T, ny]."""
    e, = as_tensors(e)
    return torch.sqrt(torch.mean(torch.square(e), dim=0))


def compute_nis(e: torch.Tensor, S: torch.Tensor) -> torch.Tensor:
    """Normalized innovation squared ``eᵀ S⁻¹ e`` per step; ``e``
    [T, ny], ``S`` [T, ny, ny]."""
    e, S = as_tensors(e, S)
    sol = torch.linalg.solve(S, e[..., None])[..., 0]
    return torch.einsum("ti,ti->t", e, sol)


def nis_bounds(ny: int, sigma: float = 0.95) -> tuple[float, float]:
    """χ²_ny bounds that hold ``sigma`` of the probability mass."""
    from scipy import stats

    lo = float(stats.chi2.ppf((1 - sigma) / 2, ny))
    hi = float(stats.chi2.ppf(1 - (1 - sigma) / 2, ny))
    return lo, hi


def _lag_sums(a: torch.Tensor, b: torch.Tensor, maxlag: int) -> torch.Tensor:
    """``S[l] = Σ_t a[t + l] ⊗ b[t]`` for l = 0..maxlag in one batched
    product: ``a`` [T, na], ``b`` [T, nb] -> [maxlag + 1, na, nb].  Row
    t of the zero-padded ``a``'s windows holds a[t], ..., a[t + maxlag]."""
    T = a.shape[0]
    pad = a.new_zeros((maxlag,) + a.shape[1:])
    win = torch.cat([a, pad]).unfold(0, maxlag + 1, 1)[:T]  # [T, na, L]
    return torch.einsum("til,tj->lij", win, b)


def _centred(x: torch.Tensor) -> torch.Tensor:
    return x - torch.mean(x, dim=0)


def autocor(x: torch.Tensor, maxlag: int) -> torch.Tensor:
    """Sample autocorrelation of ``x`` [T] for lags 0..maxlag, normalized
    by the lag-0 sum (StatsBase.autocor's convention)."""
    x, = as_tensors(x)
    xc = _centred(x)[:, None]
    return (_lag_sums(xc, xc, maxlag) / torch.sum(xc * xc))[:, 0, 0]


def crosscor(x: torch.Tensor, y: torch.Tensor, maxlag: int) -> torch.Tensor:
    """Cross-correlation of ``x`` with lagged ``y`` for lags 1..maxlag,
    normalized by the product of the deviations (StatsBase.crosscor's
    convention)."""
    x, y = as_tensors(x, y)
    xc, yc = _centred(x)[:, None], _centred(y)[:, None]
    den = torch.sqrt(torch.sum(xc ** 2) * torch.sum(yc ** 2))
    return (_lag_sums(xc, yc, maxlag)[1:] / den)[:, 0, 0]


def whiteness_bound(T: int, level: float = 0.95) -> float:
    """The white-noise confidence bound z/√T (1.96/√T at 95 %)."""
    from scipy import stats

    z = float(stats.norm.ppf(0.5 + level / 2))
    return z / np.sqrt(T)


def validation_stats(sol, sigma: float = 0.95,
                     maxlag: Optional[int] = None) -> dict:
    """Every ``validationplot`` statistic as tensors: ``rms`` [ny],
    ``autocorrelation`` [maxlag + 1, ny], with ``S`` also ``nis`` [T] and
    ``nis_bounds``, with inputs ``crosscorrelation`` [maxlag, nu, ny];
    ``maxlag`` and ``whiteness_bound`` as numbers."""
    e, = as_tensors(sol.e, like=sol)
    T, ny = e.shape
    maxlag = min(50, T // 4) if maxlag is None else maxlag
    ec = _centred(e)
    auto = _lag_sums(ec, ec, maxlag)
    var = torch.sum(ec * ec, dim=0)
    out = {
        "rms": innovation_rms(e),
        "maxlag": maxlag,
        "whiteness_bound": whiteness_bound(T),
        "autocorrelation": torch.diagonal(auto, dim1=1, dim2=2) / var,
    }
    if getattr(sol, "S", None) is not None:
        out["nis"] = compute_nis(*as_tensors(e, sol.S))
        out["nis_bounds"] = nis_bounds(ny, sigma)
    u = getattr(sol, "u", None)
    u = None if u is None else as_tensors(e, u)[1]
    if u is not None and u.numel() and u.shape[-1]:
        uc = _centred(u.to(dtype=e.dtype, device=e.device))
        den = torch.sqrt(var[None, :] * torch.sum(uc * uc, dim=0)[:, None])
        cross = _lag_sums(ec, uc, maxlag)[1:].transpose(1, 2)
        out["crosscorrelation"] = cross / den          # [maxlag, nu, ny]
    return out


def kde(x: torch.Tensor, we: Optional[torch.Tensor] = None,
        npoints: int = 200, bandwidth: Optional[float] = None):
    """Weighted Gaussian kernel density estimate of samples ``x`` [N] with
    normalized weights ``we`` (uniform if None).  Returns ``(grid,
    density)``, ``npoints`` each, on ``x``'s device.  The bandwidth
    defaults to Silverman's rule on the weighted deviation and the
    effective sample size."""
    x, we = as_tensors(x, we)
    N = x.shape[0]
    if we is None:
        we = torch.full((N,), 1.0 / N, dtype=x.dtype, device=x.device)
    m = torch.sum(we * x)
    sd = torch.sqrt(torch.sum(we * (x - m) ** 2))
    neff = 1.0 / torch.sum(we ** 2)
    if bandwidth is None:
        bandwidth = 1.06 * sd * neff ** (-0.2) + 1e-12
    lo = torch.min(x) - 3 * bandwidth
    hi = torch.max(x) + 3 * bandwidth
    s = torch.arange(npoints, dtype=x.dtype, device=x.device) / (npoints - 1)
    grid = lo * (1 - s) + hi * s
    z = (grid[:, None] - x[None, :]) / bandwidth
    dens = torch.sum(we[None, :] * torch.exp(-0.5 * z ** 2), dim=1) / (
        bandwidth * math.sqrt(2 * math.pi))
    return grid, dens


def _host(v):
    return None if v is None else torch.as_tensor(v).detach().cpu().numpy()


def diagnose_solution(sol, f=None) -> dict:
    """Which step of a solution went bad, and why: the ``debug=true``
    analogue.  The filters do not raise mid-trajectory; they propagate
    NaNs and clear ``sol.ok``.  Given a solution, on any device, this
    reports ``ok`` and, when not ok, ``first_bad_step``, ``reason``, the
    innovation covariance ``S`` at that step with its eigenvalues, and
    the innovation ``e`` (numpy arrays)."""
    ok = _host(getattr(sol, "ok", None))
    if ok is None or bool(ok.all()):
        return {"ok": True}
    t = int(np.argmax(~ok))
    out = {"ok": False, "first_bad_step": t}
    S, e, xt = (None if getattr(sol, k, None) is None
                else _host(getattr(sol, k)[t]) for k in ("S", "e", "xt"))
    reasons = []
    if S is not None:
        out["S"] = S
        if not np.all(np.isfinite(S)):
            reasons.append("innovation covariance S is not finite")
        else:
            ev = np.linalg.eigvalsh(0.5 * (S + S.T))
            out["S_eigenvalues"] = ev
            if ev.min() <= 0:
                reasons.append(
                    f"innovation covariance S is not positive definite "
                    f"(min eigenvalue {ev.min():.3g}) — Cholesky failed at "
                    f"step {t}")
    if e is not None:
        out["e"] = e
        if not np.all(np.isfinite(e)):
            reasons.append("innovation e is not finite")
    if xt is not None and not np.all(np.isfinite(xt)):
        reasons.append("filtered state went non-finite")
    if not reasons:
        reasons.append("step flagged not-ok (non-finite quantity upstream)")
    out["reason"] = "; ".join(reasons)
    return out
