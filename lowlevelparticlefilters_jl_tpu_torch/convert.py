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
    if isinstance(a, torch.Tensor):
        return a.to(dtype=dtype, device=device)
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


def sqkf_from_numpy(A, B, C, D, R1, R2, d0_mean=None, d0_cov=None, *,
                    Ts: float = 1.0, alpha: float = 1.0,
                    dtype=torch.float64, device=None):
    """A :class:`~.filters.sqkf.SqKalmanFilter` from arrays: R1 and R2
    are covariances (factored by the filter), d0 defaults to N(0, R1)."""
    from .filters.sqkf import SqKalmanFilter

    device = default_device(device)
    d0 = None if d0_cov is None else _density(d0_mean, d0_cov, dtype, device)
    if D is not None and not callable(D) and np.ndim(D) == 0 \
            and float(D) == 0.0:
        D = None
    return SqKalmanFilter(*(_mat(M, dtype, device)
                            for M in (A, B, C, D, R1, R2)), d0=d0, Ts=Ts,
                          alpha=alpha)


def sqekf_from_numpy(dynamics: Callable, measurement: Callable, R1, R2,
                     d0_mean=None, d0_cov=None, *, Ts: float = 1.0,
                     nu: int = -1, alpha: float = 1.0, Ajac=None, Cjac=None,
                     dtype=torch.float64, device=None):
    """A square-root EKF (:func:`~.filters.sqkf.make_sqekf`) from the
    covariance arrays around the torch callbacks."""
    from .filters.sqkf import make_sqekf

    device = default_device(device)
    d0 = None if d0_cov is None else _density(d0_mean, d0_cov, dtype, device)
    return make_sqekf(dynamics, measurement, _t(R1, dtype, device),
                      _t(R2, dtype, device), d0, Cjac=Cjac, Ajac=Ajac,
                      nu=nu, Ts=Ts, alpha=alpha)


def uikf_from_numpy(A, B, C, D, R1, R2, G, d0_mean=None, d0_cov=None, *,
                    nd: int = -1, Ts: float = 1.0, dtype=torch.float64,
                    device=None):
    """A :class:`~.filters.uikf.UIKalmanFilter`: the inner KF from the
    arrays as :func:`kalman_filter_from_numpy` builds it, and the
    unknown-input matrix ``G`` (an array or a torch callable, then with
    ``nd``)."""
    from .filters.uikf import UIKalmanFilter

    device = default_device(device)
    kf = kalman_filter_from_numpy(A, B, C, D, R1, R2, d0_mean, d0_cov, Ts=Ts,
                                  dtype=dtype, device=device)
    return UIKalmanFilter(kf=kf, G=_mat(G, dtype, device), nd=nd)


def enkf_from_numpy(N: int, dynamics: Callable, measurement: Callable, R1,
                    R2, d0_mean=None, d0_cov=None, *, inflation: float = 1.0,
                    Ts: float = 1.0, nu: int = -1, dtype=torch.float64,
                    device=None):
    """An :class:`~.filters.enkf.EnsembleKalmanFilter` of N members from
    the covariance arrays around the torch callbacks; d0 defaults to
    N(0, R1)."""
    from .filters.enkf import EnsembleKalmanFilter

    device = default_device(device)
    return EnsembleKalmanFilter(
        dynamics=dynamics, measurement=measurement, R1=_t(R1, dtype, device),
        R2=_t(R2, dtype, device),
        d0=_density(d0_mean, R1 if d0_cov is None else d0_cov, dtype,
                    device), N=N, inflation=inflation, Ts=Ts, nu=nu)


def imm_from_numpy(models, P, mu0, *, interact: bool = True, p=None,
                   dtype=torch.float64, device=None):
    """An :class:`~.filters.imm.InteractingMultipleModels` over the port's
    mode filters (built by the constructors here) with the transition
    matrix ``P`` and the initial mode probabilities ``mu0`` from
    arrays."""
    from .filters.imm import InteractingMultipleModels

    device = default_device(device)
    return InteractingMultipleModels(
        models=tuple(models), P=_t(P, dtype, device),
        mu0=_t(mu0, dtype, device), p=p, interact=interact)


def rbpf_from_numpy(N: int, kf: KalmanFilter, dynamics: Callable,
                    measurement: Callable, R2, R1n, d0n_cov, *,
                    d0n_mean=None, An=None, ny: int = -1,
                    resample_threshold: float = 0.1,
                    resampling_strategy: str = "systematic",
                    augmented_dynamics: bool = False,
                    single_riccati: Optional[bool] = None, Ts: float = 1.0,
                    nu: int = -1, dtype=torch.float32, device=None):
    """An :class:`~.filters.rbpf.RBPF` around the linear substate's KF
    (built by :func:`kalman_filter_from_numpy`) and the torch callbacks
    ``dynamics(xn, u, p, t)`` and ``measurement(xn, u, p, t)``: R2, R1n,
    the nonlinear state's initial density and ``An`` (an array, a torch
    callable or None) from arrays."""
    from .filters.rbpf import RBMeasurementModel, RBPF

    device = default_device(device)
    R2 = _t(R2, dtype, device)
    return RBPF(
        N=N, kf=kf, dynamics=dynamics,
        nl_measurement_model=RBMeasurementModel(
            measurement=measurement, R2=R2,
            ny=R2.shape[-1] if ny < 0 else ny),
        R1n=_t(R1n, dtype, device),
        d0n=_density(d0n_mean, d0n_cov, dtype, device),
        An=None if An is None else _mat(An, dtype, device),
        resample_threshold=resample_threshold,
        resampling_strategy=resampling_strategy, Ts=Ts, nu=nu,
        augmented_dynamics=augmented_dynamics, single_riccati=single_riccati)


def mukf_from_numpy(dynamics: Callable, measurement: Callable, A, Cl, R1,
                    R2, d0_mean, d0_cov, nxn: int, *, n_inds=None,
                    l_inds=None, weight_params=None, Ts: float = 1.0,
                    nu: int = -1, dtype=torch.float64, device=None):
    """A :class:`~.filters.mukf.MUKF` from the arrays ``A`` ([An; Al]),
    ``Cl``, R1, R2 and the full state's initial density (``A``/``Cl`` may
    be torch callables of ``(xn, u, p, t)``) around the torch callbacks
    ``dynamics(xn, u, p, t)`` and ``measurement(xn, u, p, t)``."""
    from .filters.mukf import MUKF
    from .filters.rbpf import RBMeasurementModel
    from .models.sigmapoints import MerweParams

    device = default_device(device)
    R2 = _t(R2, dtype, device)
    return MUKF(
        dynamics=dynamics,
        nl_measurement_model=RBMeasurementModel(measurement=measurement,
                                                R2=R2, ny=R2.shape[-1]),
        A=_mat(A, dtype, device), Cl=_mat(Cl, dtype, device),
        R1=_t(R1, dtype, device),
        d0=_density(d0_mean, d0_cov, dtype, device), nxn=nxn, Ts=Ts, nu=nu,
        weight_params=weight_params or MerweParams(), n_inds=n_inds,
        l_inds=l_inds)


def daeukf_from_numpy(dynamics: Callable, measurement: Callable,
                      residual: Callable, get_x_z: Callable,
                      build_xz: Callable, R1, R2, d0_mean, d0_cov, xz0, *,
                      weight_params=None, constraint_solver=None,
                      Ts: float = 1.0, nu: int = -1, dtype=torch.float64,
                      device=None):
    """A :class:`~.filters.daeukf.DAEUnscentedKalmanFilter` from R1, R2,
    the differential state's initial density and the initial descriptor
    ``xz0`` around the torch callbacks."""
    from .filters.daeukf import DAEUnscentedKalmanFilter
    from .models.sigmapoints import TrivialParams

    device = default_device(device)
    return DAEUnscentedKalmanFilter(
        dynamics=dynamics, measurement=measurement, residual=residual,
        get_x_z=get_x_z, build_xz=build_xz, R1=_t(R1, dtype, device),
        R2=_t(R2, dtype, device),
        d0=_density(d0_mean, d0_cov, dtype, device),
        xz0=_t(xz0, dtype, device), Ts=Ts, nu=nu,
        weight_params=weight_params or TrivialParams(),
        constraint_solver=constraint_solver)


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
