"""Build the port's filters from NumPy parameters.

A model defined in the JAX package carries across as
``np.asarray(...)`` of its arrays; nothing here imports JAX.  Callbacks
(a particle filter's, a UKF's or EKF's dynamics and measurement, the UT
hooks) are code, not parameters: they cannot be converted and are
supplied in PyTorch by the caller.  Tensors go to the card unless ``device`` says otherwise, and
without a card a call that names no device raises.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .filters.ekf import ExtendedKalmanFilter, make_ekf
from .filters.kalman import KalmanFilter
from .filters.particle import AdvancedParticleFilter, ParticleFilter
from .filters.ukf import UnscentedKalmanFilter, make_ukf
from .kernels._lib import default_device
from .ops import distributions as dist
from .ops.matrices import indexing_matrix
from .ops.mvnormal import MvNormal
from .utils.solutions import KalmanFilteringSolution, ParticleFilteringSolution


def _t(a, dtype, device) -> Optional[torch.Tensor]:
    if a is None:
        return None
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


def _mat(a, dtype, device):
    """A system matrix: arrays become tensors; a callable (written in
    PyTorch by the caller) passes through; an indexing matrix (any object
    with ``inds`` and ``n``, the JAX package's among them) becomes the
    port's."""
    if hasattr(a, "inds") and hasattr(a, "n"):
        return indexing_matrix(np.asarray(a.inds), a.n, device=device)
    if callable(a):
        return a
    return _t(a, dtype, device)


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
    be ``[T, ...]`` time-stacked, a torch callable ``(x, u, p, t) -> M``
    (callables cannot cross packages: each side writes its own from the
    same constants) or, for ``C``, an indexing matrix.  ``D`` of 0 or None
    means no feedthrough; ``d0`` defaults to N(0, R1)."""
    device = default_device(device)
    d0 = None
    if d0_cov is not None:
        d0 = _density(d0_mean, d0_cov, dtype, device)
    if D is not None and not callable(D) and np.ndim(D) == 0 \
            and float(D) == 0.0:
        D = None
    return KalmanFilter(*(_mat(M, dtype, device)
                          for M in (A, B, C, D, R1, R2)), d0=d0,
                        Ts=Ts, alpha=alpha)


def density_from_numpy(d, *, dtype=torch.float32, device=None):
    """The port's counterpart of a scalar-family density or a
    ``TupleProduct`` of them, read field by field from any object of the
    same class name and fields (the JAX package's among them).  A Python
    number stays one, so kernel A admits the density as the JAX kernel
    does; an array parameter becomes a tensor."""
    name = type(d).__name__
    if name == "TupleProduct":
        return dist.TupleProduct([density_from_numpy(c, dtype=dtype,
                                                     device=device)
                                  for c in d.dists])
    cls = {c.__name__: c for c in dist.SCALAR_FAMILIES}.get(name)
    if cls is None:
        raise TypeError(f"not a scalar-family density: {name}")
    import dataclasses

    vals = {}
    for f in dataclasses.fields(cls):
        v = getattr(d, f.name)
        vals[f.name] = v if isinstance(v, (int, float)) else _t(
            v, dtype, default_device(device))
    return cls(**vals)


def particle_filter_from_numpy(N: int, dynamics: Callable,
                               measurement: Callable, R1, R2, d0_cov, *,
                               R1_mean=None, R2_mean=None, d0_mean=None,
                               measurement_density=None,
                               resample_threshold: float = 0.1,
                               resampling_strategy: str = "systematic",
                               exact_resample: bool = False,
                               Ts: float = 1.0, noise_backend: str = "torch",
                               dtype=torch.float32, device=None
                               ) -> ParticleFilter:
    """A bootstrap :class:`ParticleFilter` with Gaussian densities from
    arrays and the torch callbacks ``dynamics``/``measurement``.  A
    ``measurement_density`` object (see :func:`density_from_numpy`)
    takes the place of N(R2_mean, R2)."""
    device = default_device(device)
    dm = (_density(R2_mean, R2, dtype, device) if measurement_density is None
          else measurement_density)
    return ParticleFilter(
        N=N, dynamics=dynamics, measurement=measurement,
        dynamics_density=_density(R1_mean, R1, dtype, device),
        measurement_density=dm,
        initial_density=_density(d0_mean, d0_cov, dtype, device),
        resample_threshold=resample_threshold,
        resampling_strategy=resampling_strategy,
        exact_resample=exact_resample, Ts=Ts, noise_backend=noise_backend)


def advanced_particle_filter_from_numpy(
        N: int, dynamics: Callable, measurement: Callable,
        measurement_likelihood: Callable, d0_cov, *, d0_mean=None,
        resample_threshold: float = 0.5,
        resampling_strategy: str = "systematic",
        exact_resample: bool = False, Ts: float = 1.0, nu: int = -1,
        ny: int = -1, noise_dim: int = -1, dtype=torch.float32,
        device=None) -> AdvancedParticleFilter:
    """An :class:`AdvancedParticleFilter` with the initial density from
    arrays around the torch callbacks (``dynamics(x, u, p, t, noise)``
    with ``noise`` standard normals or None)."""
    device = default_device(device)
    return AdvancedParticleFilter(
        N=N, dynamics=dynamics, measurement=measurement,
        measurement_likelihood=measurement_likelihood,
        initial_density=_density(d0_mean, d0_cov, dtype, device),
        resample_threshold=resample_threshold,
        resampling_strategy=resampling_strategy,
        exact_resample=exact_resample, Ts=Ts, nu=nu, ny=ny,
        noise_dim=noise_dim)


def ukf_from_numpy(dynamics: Callable, measurement: Callable, R1, R2,
                   d0_mean=None, d0_cov=None, *, weight_params=None,
                   Ts: float = 1.0, nu: int = 0, dtype=torch.float32,
                   device=None, **hooks) -> UnscentedKalmanFilter:
    """An additive-noise UKF from the JAX filter's arrays (R1, R2, the
    initial density; d0 defaults to N(0, R1)), its weight scheme and Ts,
    around the torch callbacks ``dynamics``/``measurement``.  ``hooks``
    (``innovation``, ``measurement_mean``, ``state_mean``, ...) pass to
    :func:`make_ukf` as they are."""
    from .models.sigmapoints import TrivialParams

    device = default_device(device)
    d0 = None if d0_cov is None else _density(d0_mean, d0_cov, dtype, device)
    return make_ukf(dynamics, measurement, _t(R1, dtype, device),
                    _t(R2, dtype, device), d0, nu=nu, Ts=Ts,
                    weight_params=weight_params or TrivialParams(), **hooks)


def ekf_from_numpy(dynamics: Callable, measurement: Callable, R1, R2,
                   d0_mean=None, d0_cov=None, *, alpha: float = 1.0,
                   Ts: float = 1.0, nu: int = 0, Ajac=None, Cjac=None,
                   dtype=torch.float32, device=None) -> ExtendedKalmanFilter:
    """An EKF from the JAX filter's arrays (R1, R2, the initial density),
    alpha and Ts, around the torch callbacks (and optional Jacobian
    callbacks ``Ajac``/``Cjac``)."""
    device = default_device(device)
    d0 = None if d0_cov is None else _density(d0_mean, d0_cov, dtype, device)
    return make_ekf(dynamics, measurement, _t(R1, dtype, device),
                    _t(R2, dtype, device), d0, nu=nu, Ts=Ts, alpha=alpha,
                    Ajac=Ajac, Cjac=Cjac)


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


def _solution_fields(sol, names, dtype, device) -> dict:
    """The named array fields of ``sol`` as tensors: floating arrays in
    ``dtype``, boolean ones as they are; a missing or None field stays
    None."""
    out = {}
    for name in names:
        a = getattr(sol, name, None)
        if a is None:
            out[name] = None
            continue
        a = np.array(a)
        out[name] = torch.as_tensor(
            a, dtype=torch.bool if a.dtype == np.bool_ else dtype,
            device=device)
    return out


def kalman_solution_from_numpy(sol, *, dtype=torch.float64, device=None
                               ) -> KalmanFilteringSolution:
    """A :class:`KalmanFilteringSolution` from the arrays of a filtering
    solution of the JAX package (or any object with its fields ``u, y, x,
    xt, R, Rt, ll, e, K, S, t, ok``), so that a smoother of each package
    can run on one shared forward pass."""
    device = default_device(device)
    f = _solution_fields(sol, ("u", "y", "x", "xt", "R", "Rt", "ll", "e",
                               "K", "S", "t", "ok"), dtype, device)
    return KalmanFilteringSolution(**f, route="converted")


def particle_solution_from_numpy(sol, *, dtype=torch.float32, device=None
                                 ) -> ParticleFilteringSolution:
    """A :class:`ParticleFilteringSolution` from the arrays of a particle
    filtering solution (fields ``u, y, x, w, we, ll``)."""
    device = default_device(device)
    f = _solution_fields(sol, ("u", "y", "x", "w", "we", "ll"), dtype,
                         device)
    return ParticleFilteringSolution(**f, route="converted")
