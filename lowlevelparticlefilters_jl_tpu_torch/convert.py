"""Build the port's filters from NumPy parameters.

A model defined in the JAX package carries across as
``np.asarray(...)`` of its arrays; nothing here imports JAX.  A particle
filter's callbacks are code, not parameters, and are supplied in
PyTorch.  Tensors go to the card unless ``device`` says otherwise, and
without a card a call that names no device raises.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .filters.kalman import KalmanFilter
from .filters.particle import ParticleFilter
from .kernels._lib import default_device
from .ops.mvnormal import MvNormal


def _t(a, dtype, device) -> Optional[torch.Tensor]:
    if a is None:
        return None
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


def _density(mean, cov, dtype, device) -> MvNormal:
    cov = _t(cov, dtype, device)
    mean = (torch.zeros(cov.shape[-1], dtype=dtype, device=device)
            if mean is None else _t(mean, dtype, device))
    return MvNormal(mean, cov)


def kalman_filter_from_numpy(A, B, C, D, R1, R2, d0_mean=None, d0_cov=None,
                             *, Ts: float = 1.0, alpha: float = 1.0,
                             dtype=torch.float64, device=None
                             ) -> KalmanFilter:
    """A :class:`KalmanFilter` from arrays.  ``A`` (and the others) may
    be ``[T, ...]`` time-stacked.  ``D`` of 0 or None means no
    feedthrough; ``d0`` defaults to N(0, R1)."""
    device = default_device(device)
    d0 = None
    if d0_cov is not None:
        d0 = _density(d0_mean, d0_cov, dtype, device)
    if D is not None and np.ndim(D) == 0 and float(D) == 0.0:
        D = None
    return KalmanFilter(_t(A, dtype, device), _t(B, dtype, device),
                        _t(C, dtype, device), _t(D, dtype, device),
                        _t(R1, dtype, device), _t(R2, dtype, device), d0=d0,
                        Ts=Ts, alpha=alpha)


def particle_filter_from_numpy(N: int, dynamics: Callable,
                               measurement: Callable, R1, R2, d0_cov, *,
                               R1_mean=None, R2_mean=None, d0_mean=None,
                               resample_threshold: float = 0.1,
                               resampling_strategy: str = "systematic",
                               Ts: float = 1.0, noise_backend: str = "torch",
                               dtype=torch.float32, device=None
                               ) -> ParticleFilter:
    """A bootstrap :class:`ParticleFilter` with Gaussian densities from
    arrays and the torch callbacks ``dynamics``/``measurement``."""
    device = default_device(device)
    return ParticleFilter(
        N=N, dynamics=dynamics, measurement=measurement,
        dynamics_density=_density(R1_mean, R1, dtype, device),
        measurement_density=_density(R2_mean, R2, dtype, device),
        initial_density=_density(d0_mean, d0_cov, dtype, device),
        resample_threshold=resample_threshold,
        resampling_strategy=resampling_strategy, Ts=Ts,
        noise_backend=noise_backend)


def linear_callbacks(A, B, C, dtype=torch.float32, device=None):
    """``f(x, u, p, t) = A x + B u`` and ``g(x, u, p, t) = C x`` as torch
    callbacks over the given arrays (the benchmark's model form)."""
    device = default_device(device)
    At, Bt, Ct = (_t(M, dtype, device) for M in (A, B, C))

    def dynamics(x, u, p, t):
        return At @ x + Bt @ u

    def measurement(x, u, p, t):
        return Ct @ x

    return dynamics, measurement
