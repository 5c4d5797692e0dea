"""Multivariate-normal density (counterpart of ``ops/mvnormal.py``).

``sample`` takes an explicit ``torch.Generator`` where the JAX package
takes a PRNG key.
"""
from __future__ import annotations

from typing import Optional

import torch

from .linalg import chol_lower, tri_solve
from ..utils.struct import struct

_LOG2PI = 1.8378770664093453


def mvnormal_logpdf(x: torch.Tensor, mean: torch.Tensor,
                    chol: torch.Tensor) -> torch.Tensor:
    """logpdf of N(mean, L L^T) at x; leading batch axes on ``x``."""
    d = x - mean
    k = d.shape[-1]
    if chol.ndim == 2 and d.ndim > 1:
        # one multi-RHS solve for the whole batch: L Z = Dᵀ
        z = tri_solve(chol, d.reshape(-1, k).T, lower=True)
        quad = torch.square(z).sum(0).reshape(d.shape[:-1])
    else:
        z = tri_solve(chol.expand(*d.shape[:-1], k, k), d[..., None],
                      lower=True)[..., 0]
        quad = torch.square(z).sum(-1)
    logdet = 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
    return -0.5 * (k * _LOG2PI + logdet + quad)


def mvnormal_logpdf_cov(x: torch.Tensor, mean: torch.Tensor,
                        cov: torch.Tensor) -> torch.Tensor:
    """logpdf of N(mean, cov) at x (factorizes cov on the fly)."""
    return mvnormal_logpdf(x, mean, chol_lower(cov))


@struct
class MvNormal:
    """Gaussian density with tensors ``mean`` [n] and ``cov`` [n, n]."""

    mean: torch.Tensor
    cov: torch.Tensor

    @property
    def dim(self) -> int:
        return self.mean.shape[-1]

    def chol(self) -> torch.Tensor:
        return chol_lower(self.cov)

    def logpdf(self, x: torch.Tensor) -> torch.Tensor:
        return mvnormal_logpdf(x, self.mean, self.chol())

    def sample(self, generator: Optional[torch.Generator],
               shape: tuple = ()) -> torch.Tensor:
        z = torch.randn((*shape, self.dim), generator=generator,
                        dtype=self.mean.dtype, device=self.mean.device)
        return self.mean + z @ self.chol().T


def as_mvnormal(d, dim_hint: int | None = None) -> MvNormal:
    """Coerce a covariance matrix or MvNormal-like into an MvNormal; a
    bare covariance matrix means a zero-mean Gaussian."""
    if isinstance(d, MvNormal):
        return d
    if hasattr(d, "mean") and hasattr(d, "cov") and not hasattr(d, "shape"):
        return MvNormal(torch.as_tensor(d.mean), torch.as_tensor(d.cov))
    arr = torch.as_tensor(d)
    if arr.ndim == 2 and arr.shape[0] == arr.shape[1]:
        return MvNormal(arr.new_zeros(arr.shape[0]), arr)
    if arr.ndim == 1:
        if dim_hint is not None and arr.shape[0] != dim_hint:
            raise ValueError("cannot interpret 1-D array as a density")
        return MvNormal(torch.zeros_like(arr), torch.diag(arr))
    raise TypeError("initial/noise density must be an MvNormal or a "
                    "covariance matrix; got " + repr(type(d)))
