"""Discretization helpers: RK4 and integrator covariances (counterpart of
``ops/discretize.py``).

``rk4`` returns discrete dynamics; ``supersample`` steps run in a Python
loop.  The covariance builders return float64 tensors on the CPU unless
``dtype`` and ``device`` say otherwise.
"""
from __future__ import annotations

import math

import torch


def rk4(f, Ts: float, supersample: int = 1):
    """Discretize continuous dynamics ``f(x, u, p, t) -> dx/dt`` with
    ``supersample`` classic Runge-Kutta steps of ``Ts / supersample``:
    returns ``fd(x, u, p, t) -> x(t + Ts)``."""
    if supersample < 1:
        raise ValueError("supersample must be positive")
    h = Ts / supersample

    def fd(x, u, p, t, *args, **kwargs):
        for _ in range(supersample):
            f1 = f(x, u, p, t, *args, **kwargs)
            f2 = f(x + 0.5 * h * f1, u, p, t + 0.5 * h, *args, **kwargs)
            f3 = f(x + 0.5 * h * f2, u, p, t + 0.5 * h, *args, **kwargs)
            f4 = f(x + h * f3, u, p, t + h, *args, **kwargs)
            x = x + (h / 6.0) * (f1 + 2.0 * f2 + 2.0 * f3 + f4)
            t = t + h
        return x

    return fd


def double_integrator_covariance(Ts: float, s2: float = 1.0, *,
                                 dtype=torch.float64, device=None
                                 ) -> torch.Tensor:
    """Double-integrator covariance for a piecewise-constant force."""
    return s2 * torch.tensor([[Ts**4 / 4, Ts**3 / 2], [Ts**3 / 2, Ts**2]],
                             dtype=dtype, device=device)


def double_integrator_covariance_smooth(Ts: float, s2: float = 1.0, *,
                                        dtype=torch.float64, device=None
                                        ) -> torch.Tensor:
    """Double-integrator covariance for continuous white noise."""
    return s2 * torch.tensor([[Ts**3 / 3, Ts**2 / 2], [Ts**2 / 2, Ts]],
                             dtype=dtype, device=device)


def n_integrator_covariance(n: int, Ts: float, s2: float = 1.0, *,
                            dtype=torch.float64, device=None
                            ) -> torch.Tensor:
    """Rank-1 n-integrator covariance for a piecewise-constant force."""
    B = torch.tensor([Ts ** (n - i) / math.factorial(n - i)
                      for i in range(n)], dtype=dtype, device=device)
    return s2 * torch.outer(B, B)


def n_integrator_covariance_smooth(n: int, Ts: float, s2: float = 1.0, *,
                                   dtype=torch.float64, device=None
                                   ) -> torch.Tensor:
    """Full-rank n-integrator covariance for continuous white noise."""
    rows = []
    for i in range(1, n + 1):
        row = []
        for j in range(1, n + 1):
            q = 2 * n - i - j + 1
            row.append(s2 * Ts**q / (q * math.factorial(n - i)
                                     * math.factorial(n - j)))
        rows.append(row)
    return torch.tensor(rows, dtype=dtype, device=device)
