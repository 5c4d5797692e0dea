"""Solution containers (counterpart of ``utils/solutions.py``).

Per-step histories are stacked tensors with time in the leading axis,
exactly as the JAX package stores them.
"""
from __future__ import annotations

from typing import Any

import torch

from .struct import struct


@struct
class KalmanFilteringSolution:
    """Result of `forward_trajectory` for Kalman filters.

    - ``x``  : predictions x(t|t-1), [T, nx]
    - ``xt`` : filtered estimates x(t|t), [T, nx]
    - ``R``  : predicted covariances R(t|t-1), [T, nx, nx]
    - ``Rt`` : filtered covariances R(t|t), [T, nx, nx]
    - ``ll`` : total log-likelihood (scalar)
    - ``e``  : innovations [T, ny]
    - ``K``  : Kalman gains [T, nx, ny]
    - ``S``  : innovation covariances [T, ny, ny]
    - ``ok`` : per-step flag, True where every quantity is finite
    - ``route`` : which execution path produced the solution
    """

    u: Any
    y: Any
    x: torch.Tensor
    xt: torch.Tensor
    R: torch.Tensor
    Rt: torch.Tensor
    ll: torch.Tensor
    e: torch.Tensor
    K: torch.Tensor = None
    S: torch.Tensor = None
    extra: Any = None
    t: torch.Tensor = None
    ok: torch.Tensor = None
    route: Any = None


@struct
class KalmanSmoothingSolution:
    """A filtering solution plus the smoothed estimates:

    - ``xT`` : smoothed states x(t|T), [T, nx]
    - ``RT`` : smoothed covariances R(t|T), [T, nx, nx]

    Other attributes are read through from ``sol``.
    """

    sol: KalmanFilteringSolution
    xT: torch.Tensor
    RT: torch.Tensor

    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, "sol"), name)


@struct
class ParticleFilteringSolution:
    """Result of `forward_trajectory` for particle filters:

    - ``x``  : particles, [T, N, nx]
    - ``w``  : normalized log-weights, [T, N]
    - ``we`` : normalized exp-weights, [T, N]
    - ``ll`` : total log-likelihood
    """

    u: Any
    y: Any
    x: torch.Tensor
    w: torch.Tensor
    we: torch.Tensor
    ll: torch.Tensor
    extra: Any = None
    route: Any = None
