"""The reference's flat function API over filter states (counterpart of
``compat.py``): ``state``, ``covariance``, ``num_particles``, ``weights``,
``expweights``, ``particles``, ``update``/``predict``/``correct``/
``reset``, ``shouldresample``, ``sample_measurement``.  Nothing mutates:
every verb of the reference that mutates returns the new state here.
"""
from __future__ import annotations

import warnings

import torch

from .filters.particle import PFState
from .ops.logsumexp import effective_particles


def state(obj):
    """The point estimate of a filter state: the mean ``x`` of a Gaussian
    state, the weighted particle mean of a particle state."""
    if isinstance(obj, PFState):
        return torch.einsum("n,nd->d", obj.we, obj.x)
    if hasattr(obj, "x"):
        return obj.x
    raise TypeError(f"no state accessor for {type(obj).__name__}")


def covariance(obj):
    """The covariance of a filter state (the weighted sample covariance of
    a particle state)."""
    if isinstance(obj, PFState):
        d = obj.x - state(obj)
        return torch.einsum("n,ni,nj->ij", obj.we, d, d)
    if hasattr(obj, "U"):  # square-root states keep an upper factor
        return obj.U.T @ obj.U
    if hasattr(obj, "R"):
        return obj.R
    raise TypeError(f"no covariance accessor for {type(obj).__name__}")


def index(s):
    """The step counter of a filter state."""
    return s.t


def num_particles(pf_or_state) -> int:
    if isinstance(pf_or_state, PFState):
        return pf_or_state.x.shape[0]
    return pf_or_state.N


def weights(s: PFState) -> torch.Tensor:
    """The normalized log-weights."""
    return s.w


def expweights(s: PFState) -> torch.Tensor:
    """The normalized weights."""
    return s.we


def particles(s: PFState) -> torch.Tensor:
    """The particles [N, nx]."""
    return s.x


def particletype(s: PFState):
    """The particles' dtype."""
    return s.x.dtype


def shouldresample(we: torch.Tensor, threshold: float = 0.1):
    """The Neff trigger: ``Neff < threshold·N``."""
    return effective_particles(we) < threshold * we.shape[-1]


def update(f, s, u, y, p=None, t=None, **kw):
    """One correct-then-predict step: ``(state, info)``.  ``p`` and ``t``
    pass as keywords, since filters differ in the positions after ``y``."""
    return f.update(s, u, y, p=p, t=t, **kw)


def predict(f, s, u=None, p=None, t=None, **kw):
    """The time update."""
    return f.predict(s, u, p=p, t=t, **kw)


def correct(f, s, u, y, p=None, t=None, **kw):
    """The measurement update: ``(state, info)``."""
    return f.correct(s, u, y, p=p, t=t, **kw)


def reset(f, generator=None):
    """A fresh initial state (a particle filter draws from
    ``generator``)."""
    return f.init(generator) if generator is not None else f.init()


def sample_measurement(f, generator, x, u=None, p=None, t=0, noise=True):
    """A draw of y ~ p(y | x) from the filter's measurement model."""
    return f.sample_measurement(generator, x, u, p, t, noise=noise)


def weigthed_mean(*args, **kwargs):
    """Deprecated misspelling kept by the reference: ``weighted_mean``."""
    from .trajectory import weighted_mean

    warnings.warn("weigthed_mean is deprecated, use weighted_mean",
                  DeprecationWarning, stacklevel=2)
    return weighted_mean(*args, **kwargs)


def weigthed_cov(*args, **kwargs):
    """Deprecated misspelling kept by the reference: ``weighted_cov``."""
    from .trajectory import weighted_cov

    warnings.warn("weigthed_cov is deprecated, use weighted_cov",
                  DeprecationWarning, stacklevel=2)
    return weighted_cov(*args, **kwargs)
