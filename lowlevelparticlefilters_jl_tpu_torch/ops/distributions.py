"""Scalar noise densities and their product (counterpart of
``ops/distributions.py``).

Any object with ``logpdf(x)`` and ``sample(generator, shape)`` serves as
a particle filter's density; :class:`MvNormal` (ops/mvnormal.py) is the
Gaussian one.  The scalar families here, and :class:`TupleProduct` over
them, are the non-Gaussian building blocks:

- :class:`Normal`, :class:`Uniform` (closed interval), :class:`Laplace`,
  :class:`StudentT` (heavy tails), :class:`Binary` (two points, matched
  with ``isclose`` at rtol 1e-5, atol 1e-8), :class:`MixtureNormal`
  (two Gaussians),
- :class:`TupleProduct`: independent components along the last axis.

A parameter may be a Python number or a tensor.  With Python numbers
only, kernel A evaluates the density in its weight phase
(kernels/pf_scan.py::density_constants); a tensor parameter routes the
filter sequential.  ``sample`` takes a ``torch.Generator`` where the JAX
package takes a PRNG key; the result lies on the generator's device, in
the dtype of a tensor parameter (else PyTorch's default dtype), unless
``dtype``/``device`` say otherwise.  ``mean`` of Python numbers is a
float64 tensor.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from ..utils.struct import struct

_LOG2PI = 1.8378770664093453


def _as(v, x: torch.Tensor) -> torch.Tensor:
    """A parameter in the dtype and on the device of ``x``."""
    return torch.as_tensor(v, dtype=x.dtype, device=x.device)


def _num(v) -> torch.Tensor:
    """A parameter as a tensor: a Python number in float64."""
    return v if isinstance(v, torch.Tensor) else torch.tensor(
        v, dtype=torch.float64)


def _like(params, generator, dtype, device):
    """dtype and device of a draw: explicit, else from a tensor parameter
    (dtype) and the generator (device)."""
    ts = [v for v in params if isinstance(v, torch.Tensor)]
    if dtype is None:
        dtype = ts[0].dtype if ts else torch.get_default_dtype()
    if device is None:
        device = (generator.device if generator is not None
                  else ts[0].device if ts else "cpu")
    return dtype, device


def _normal_logpdf(x, mu, sigma):
    sigma = _as(sigma, x)
    z = (x - _as(mu, x)) / sigma
    return -0.5 * (z * z + _LOG2PI) - torch.log(sigma)


@struct
class Normal:
    """Scalar Gaussian N(mu, sigma²)."""

    mu: Any = 0.0
    sigma: Any = 1.0

    def logpdf(self, x):
        return _normal_logpdf(x, self.mu, self.sigma)

    def sample(self, generator=None, shape=(), *, dtype=None, device=None):
        dtype, device = _like((self.mu, self.sigma), generator, dtype,
                              device)
        z = torch.randn(shape, generator=generator, dtype=dtype,
                        device=device)
        return self.mu + self.sigma * z

    @property
    def mean(self):
        return _num(self.mu)


@struct
class Uniform:
    """Scalar uniform on the closed interval [lo, hi]."""

    lo: Any = 0.0
    hi: Any = 1.0

    def logpdf(self, x):
        lo, hi = _as(self.lo, x), _as(self.hi, x)
        inside = (x >= lo) & (x <= hi)
        return torch.where(inside, -torch.log(hi - lo),
                           torch.full_like(x, -math.inf))

    def sample(self, generator=None, shape=(), *, dtype=None, device=None):
        dtype, device = _like((self.lo, self.hi), generator, dtype, device)
        r = torch.rand(shape, generator=generator, dtype=dtype,
                       device=device)
        return self.lo + (self.hi - self.lo) * r

    @property
    def mean(self):
        return 0.5 * (_num(self.lo) + self.hi)


@struct
class Laplace:
    """Scalar Laplace(mu, b)."""

    mu: Any = 0.0
    b: Any = 1.0

    def logpdf(self, x):
        b = _as(self.b, x)
        return -torch.abs(x - _as(self.mu, x)) / b - torch.log(2 * b)

    def sample(self, generator=None, shape=(), *, dtype=None, device=None):
        dtype, device = _like((self.mu, self.b), generator, dtype, device)
        # inverse CDF of a uniform on (-1/2, 1/2)
        v = torch.rand(shape, generator=generator, dtype=dtype,
                       device=device) - 0.5
        return self.mu - self.b * torch.sign(v) * torch.log1p(
            -2 * torch.abs(v))

    @property
    def mean(self):
        return _num(self.mu)


@struct
class StudentT:
    """Scalar Student-t with ``df`` degrees of freedom, location ``mu``
    and scale ``sigma``."""

    df: Any = 3.0
    mu: Any = 0.0
    sigma: Any = 1.0

    def logpdf(self, x):
        v, sigma = _as(self.df, x), _as(self.sigma, x)
        z = (x - _as(self.mu, x)) / sigma
        return (torch.lgamma((v + 1) / 2) - torch.lgamma(v / 2)
                - 0.5 * torch.log(v * math.pi) - torch.log(sigma)
                - (v + 1) / 2 * torch.log1p(z * z / v))

    def sample(self, generator=None, shape=(), *, dtype=None, device=None):
        dtype, device = _like((self.df, self.mu, self.sigma), generator,
                              dtype, device)
        z = torch.randn(shape, generator=generator, dtype=dtype,
                        device=device)
        half = torch.full(shape, 0.5, dtype=dtype, device=device) * self.df
        chi2 = 2 * torch._standard_gamma(half, generator=generator)
        return self.mu + self.sigma * z / torch.sqrt(chi2 / self.df)

    @property
    def mean(self):
        return _num(self.mu)


@struct
class Binary:
    """Two-point distribution: ``a`` with probability ``pa``, else
    ``b``."""

    a: Any = 0.0
    b: Any = 1.0
    pa: Any = 0.5

    def logpdf(self, x):
        pa = _as(self.pa, x)
        is_a = torch.isclose(x, _as(self.a, x).expand_as(x), rtol=1e-5,
                             atol=1e-8)
        is_b = torch.isclose(x, _as(self.b, x).expand_as(x), rtol=1e-5,
                             atol=1e-8)
        lp = torch.where(is_a, torch.log(pa), torch.log1p(-pa))
        return torch.where(is_a | is_b, lp, torch.full_like(x, -math.inf))

    def sample(self, generator=None, shape=(), *, dtype=None, device=None):
        dtype, device = _like((self.a, self.b, self.pa), generator, dtype,
                              device)
        take_a = torch.rand(shape, generator=generator, dtype=dtype,
                            device=device) < self.pa
        a = torch.full(shape, 1.0, dtype=dtype, device=device) * self.a
        return torch.where(take_a, a, torch.zeros_like(a) + self.b)

    @property
    def mean(self):
        return self.pa * _num(self.a) + (1 - self.pa) * _num(self.b)


@struct
class MixtureNormal:
    """Two-component scalar Gaussian mixture: weight ``p1`` on
    N(mu1, sigma1²), the rest on N(mu2, sigma2²)."""

    p1: Any = 0.9
    mu1: Any = 0.0
    sigma1: Any = 1.0
    mu2: Any = 0.0
    sigma2: Any = 10.0

    def logpdf(self, x):
        p1 = _as(self.p1, x)
        l1 = _normal_logpdf(x, self.mu1, self.sigma1) + torch.log(p1)
        l2 = _normal_logpdf(x, self.mu2, self.sigma2) + torch.log1p(-p1)
        return torch.logaddexp(l1, l2)

    def sample(self, generator=None, shape=(), *, dtype=None, device=None):
        kw = dict(dtype=dtype, device=device)
        n1 = Normal(self.mu1, self.sigma1).sample(generator, shape, **kw)
        n2 = Normal(self.mu2, self.sigma2).sample(generator, shape, **kw)
        c = torch.rand(shape, generator=generator, dtype=n1.dtype,
                       device=n1.device) < self.p1
        return torch.where(c, n1, n2)

    @property
    def mean(self):
        return self.p1 * _num(self.mu1) + (1 - self.p1) * _num(self.mu2)


@struct
class TupleProduct:
    """Independent product of scalar densities along the last axis of
    ``x``; discrete and continuous components may mix."""

    dists: tuple

    def __post_init__(self):
        object.__setattr__(self, "dists", tuple(self.dists))

    @property
    def dim(self) -> int:
        return len(self.dists)

    @property
    def mean(self):
        return torch.stack([d.mean for d in self.dists])

    def logpdf(self, x):
        return sum(d.logpdf(x[..., i]) for i, d in enumerate(self.dists))

    def sample(self, generator=None, shape=(), *, dtype=None, device=None):
        return torch.stack([d.sample(generator, shape, dtype=dtype,
                                     device=device) for d in self.dists], -1)


#: the scalar families, in the order of kernel A's family codes
SCALAR_FAMILIES = (Normal, Uniform, Laplace, StudentT, Binary,
                   MixtureNormal)
