"""Unscented-transform weights and sigma points (counterpart of
``models/sigmapoints.py``).

Sigma points are a stacked ``[2L+1, L]`` tensor, the center point first;
the weight schemes and their formulas are the JAX package's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from ..ops.linalg import chol_lower, symmetrize


class UTParams:
    """Base class for unscented-transform weight parameter schemes."""


@dataclass(frozen=True)
class WikiParams(UTParams):
    """Wikipedia sigma-point scheme: spread ``α²κ``."""

    alpha: float = 1.0
    beta: float = 0.0
    kappa: float = 1.0

    def __post_init__(self):
        if self.alpha <= 0:
            raise ValueError("alpha must be positive")
        if self.kappa == 0:
            raise ValueError("kappa must be non-zero")

    @staticmethod
    def from_ak(ak: float, beta: float = 0.0) -> "WikiParams":
        """Single-parameter tuning rule."""
        if ak <= 0:
            raise ValueError("ak must be positive")
        return WikiParams(alpha=ak, beta=beta, kappa=1.0) if ak < 1 else \
            WikiParams(alpha=1.0, beta=beta, kappa=ak)


@dataclass(frozen=True)
class MerweParams(UTParams):
    """van der Merwe scheme: spread ``α²(L+κ)``."""

    alpha: float = 1e-3
    beta: float = 2.0
    kappa: float = 0.0

    def __post_init__(self):
        if self.alpha <= 0:
            raise ValueError("alpha must be positive")

    @staticmethod
    def from_ak(ak: float, beta: float = 2.0) -> "MerweParams":
        if ak <= 0:
            raise ValueError("ak must be positive")
        return MerweParams(alpha=ak, beta=beta, kappa=0.0) if ak < 1 else \
            MerweParams(alpha=1.0, beta=beta, kappa=ak)


@dataclass(frozen=True)
class TrivialParams(UTParams):
    """Equal weights — the reference default."""


@dataclass(frozen=True)
class UKFWeights:
    """UT weights: center/off-center mean and covariance weights plus the
    Cholesky pre-scaling ``W`` applied to Σ before factorization."""

    wm: float
    wc: float
    wmi: float
    wci: float
    W: float


def ukf_weights(params: UTParams, L: int) -> UKFWeights:
    """UT weights for sigma-point dimension ``L``."""
    if isinstance(params, WikiParams):
        a2k = params.alpha**2 * params.kappa
        wm = (a2k - L) / a2k
        wc = wm + 1 - params.alpha**2 + params.beta
        wi = 1 / (2 * a2k)
        return UKFWeights(wm, wc, wi, wi, a2k)
    if isinstance(params, MerweParams):
        lam = params.alpha**2 * (L + params.kappa) - L
        wm = lam / (L + lam)
        wc = wm + 1 - params.alpha**2 + params.beta
        wi = 1 / (2 * (L + lam))
        return UKFWeights(wm, wc, wi, wi, L + lam)
    if isinstance(params, TrivialParams):
        N = 2 * L + 1
        return UKFWeights(1 / N, 1 / (N - 1), 1 / N, 1 / (N - 1), float(L))
    raise TypeError(f"unknown UTParams {params!r}")


def sigmapoints(m: torch.Tensor, Sigma: torch.Tensor,
                params: UTParams = TrivialParams(),
                chol: Optional[Callable] = None) -> torch.Tensor:
    """The ``[2L+1, L]`` sigma points: row 0 is the mean, rows 1..L are
    ``m`` plus the columns of ``chol(W·Σ)``, rows L+1..2L the mirrored
    points.  ``chol`` may override the factorization; a failed
    factorization yields NaNs that surface in ``sol.ok``."""
    L = m.shape[-1]
    W = ukf_weights(params, L)
    X = chol(W.W * Sigma) if chol is not None else chol_lower(
        symmetrize(W.W * Sigma))
    dev = X.mT  # rows are scaled covariance columns
    m = m[None, :]
    return torch.cat([m, m + dev, m - dev], 0)


def _weight_vector(n: int, center: float, rest: float, like) -> torch.Tensor:
    w = torch.full((n,), rest, dtype=like.dtype, device=like.device)
    w[0] = center
    return w


def ut_mean(xs: torch.Tensor, W: UKFWeights) -> torch.Tensor:
    """Weighted sigma-point mean. ``xs``: [2L+1, n]."""
    return W.wm * xs[0] + W.wmi * xs[1:].sum(0)


def ut_cov(xs: torch.Tensor, m: torch.Tensor, W: UKFWeights) -> torch.Tensor:
    """Weighted sigma-point covariance."""
    d = xs - m
    w = _weight_vector(xs.shape[0], W.wc, W.wci, xs)
    return torch.einsum("s,si,sj->ij", w, d, d)


def ut_cross_cov(xs: torch.Tensor, x: torch.Tensor, ys: torch.Tensor,
                 y: torch.Tensor, W: UKFWeights) -> torch.Tensor:
    """Weighted cross-covariance between state and output sigma points."""
    dx = xs - x
    dy = ys - y
    w = _weight_vector(xs.shape[0], W.wc, W.wci, xs)
    return torch.einsum("s,si,sj->ij", w, dx, dy)
