"""Bootstrap particle filter (counterpart of ``filters/particle.py``).

Particles are an [N, nx] tensor; the per-particle callbacks
``f(x, u, p, t)`` and ``g(x, u, p, t)`` run under ``torch.func.vmap``,
the same callback contract as the JAX package.  The explicit
``torch.Generator`` lives in :class:`PFState` where the JAX package
threads a PRNG key.  The Neff-triggered resampling decision is taken on
the host each step (the JAX package's ``lax.cond``).

``noise_backend``:

- ``"torch"`` — process noise from ``torch.randn`` with the generator
  (the JAX package's ``"threefry"``),
- ``"kernel"`` — the initial cloud from kernel C and the process noise
  added by kernel D (kernels/noise.py; the JAX package's ``"pallas"``),
  each seeded from the generator.

``smooth`` is the FFBS particle smoother (smoothing.py::ffbs_smooth).
``AdvancedParticleFilter`` and ``AuxiliaryParticleFilter`` are not
ported yet.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from ..ops.logsumexp import logsumexp_normalize, effective_particles
from ..ops.mvnormal import as_mvnormal
from ..ops.resample import resample, resample_systematic_gather
from ..utils.solutions import ParticleFilteringSolution
from ..utils.struct import struct
from ..trajectory import _as_u_seq
from .base import AbstractParticleFilter

NOISE_BACKENDS = ("torch", "kernel")


@struct
class PFState:
    """Particle-filter state:

    - ``x``  : particles, [N, nx]
    - ``w``  : normalized log-weights, [N]
    - ``we`` : normalized exp-weights, [N]
    - ``t``  : step counter
    - ``generator``: the random stream (None: PyTorch's default)
    """

    x: torch.Tensor
    w: torch.Tensor
    we: torch.Tensor
    t: int
    generator: Optional[torch.Generator] = None


@struct
class PFInfo:
    """Per-step outputs of `correct`: ``(ll, e)``, e always 0."""

    ll: torch.Tensor
    e: torch.Tensor


def _uniform_weights(N: int, like: torch.Tensor):
    w = torch.full((N,), -torch.log(torch.tensor(float(N), dtype=like.dtype)
                                    ).item(), dtype=like.dtype,
                   device=like.device)
    we = torch.full((N,), 1.0 / N, dtype=like.dtype, device=like.device)
    return w, we


@struct
class ParticleFilter(AbstractParticleFilter):
    """Bootstrap particle filter with additive noise.

    - ``dynamics``: ``f(x, u, p, t) -> x⁺`` (additive process noise)
    - ``measurement``: ``g(x, u, p, t) -> ŷ`` (additive measurement noise)
    - densities: :class:`MvNormal` or a covariance matrix (zero mean)
    """

    N: int
    dynamics: Callable
    measurement: Callable
    dynamics_density: Any = None
    measurement_density: Any = None
    initial_density: Any = None
    p: Any = None
    resample_threshold: float = 0.1
    resampling_strategy: str = "systematic"
    exact_resample: bool = False
    Ts: float = 1.0
    nu: int = -1
    ny: int = -1
    noise_backend: str = "torch"

    def __post_init__(self):
        for name in ("dynamics_density", "measurement_density",
                     "initial_density"):
            v = getattr(self, name)
            if v is not None:
                object.__setattr__(self, name, as_mvnormal(v))
        if self.noise_backend not in NOISE_BACKENDS:
            raise ValueError(f"noise_backend must be one of {NOISE_BACKENDS}")

    @property
    def nx(self) -> int:
        return self.initial_density.dim

    def init(self, generator: Optional[torch.Generator] = None) -> PFState:
        """Draw N initial particles from the initial density."""
        d0 = self.initial_density
        if self.noise_backend == "kernel":
            from ..kernels.noise import TAG_INIT, normal
            from ..routing import seed_from_generator

            z = normal(seed_from_generator(generator), (self.N, self.nx),
                       tag=TAG_INIT, device=d0.mean.device)
            x = d0.mean + z.to(d0.mean.dtype) @ d0.chol().T
        else:
            x = d0.sample(generator, (self.N,))
        w, we = _uniform_weights(self.N, x)
        return PFState(x=x, w=w, we=we, t=0, generator=generator)

    def _maybe_resample(self, state: PFState):
        """Resampled particles and whether the Neff trigger fired."""
        N = self.N
        if self.resample_threshold < 1.0 and not bool(
                effective_particles(state.we) < self.resample_threshold * N):
            return state.x, False
        if self.resampling_strategy == "systematic" \
                and not self.exact_resample:
            return resample_systematic_gather(state.x, state.we,
                                              state.generator), True
        j = resample(state.we, state.generator, N,
                     strategy=self.resampling_strategy)
        return state.x[j], True

    def correct(self, state: PFState, u, y, p=None, t=None):
        p = self.p if p is None else p
        t = state.t * self.Ts if t is None else t
        g = self.measurement
        yhat = torch.func.vmap(lambda xi: g(xi, u, p, t))(state.x)
        logp = self.measurement_density.logpdf(y - yhat)
        # missing measurements (NaN) leave the weights untouched
        missing = torch.isnan(y).any()
        w = torch.where(missing, state.w, state.w + logp)
        w, we, ll = logsumexp_normalize(w)
        ll = torch.where(missing, torch.zeros_like(ll), ll)
        return state.replace(w=w, we=we), PFInfo(ll=ll,
                                                 e=torch.zeros_like(y))

    def predict(self, state: PFState, u=None, p=None, t=None):
        p = self.p if p is None else p
        t = state.t * self.Ts if t is None else t
        x, did_resample = self._maybe_resample(state)
        f = self.dynamics
        xn = torch.func.vmap(lambda xi: f(xi, u, p, t))(x)
        d1 = self.dynamics_density
        if d1 is not None and self.noise_backend == "kernel":
            from ..kernels.noise import add_gaussian_noise
            from ..routing import seed_from_generator

            xn = add_gaussian_noise(xn, d1.chol(),
                                    seed_from_generator(state.generator),
                                    state.t) + d1.mean
        elif d1 is not None:
            xn = xn + d1.sample(state.generator, (self.N,))
        if did_resample:
            w, we = _uniform_weights(self.N, state.w)
        else:
            w, we = state.w, state.we
        return PFState(x=xn, w=w, we=we, t=state.t + 1,
                       generator=state.generator)

    def forward_trajectory(self, u, y, p=None, *,
                           generator: Optional[torch.Generator] = None,
                           state0: PFState = None, method: str = "auto"):
        """Batch filtering, correct → save → predict each step; returns a
        :class:`ParticleFilteringSolution` with the whole cloud history."""
        from ..routing import _check_method, _record

        _check_method(method)
        T = y.shape[0]
        u_seq = _as_u_seq(u, T, y.dtype, y.device)
        p = self.p if p is None else p
        state = self.init(generator) if state0 is None else state0
        lls, xs, ws, wes = [], [], [], []
        for k in range(T):
            tk = k * self.Ts
            state, info = self.correct(state, u_seq[k], y[k], p, tk)
            lls.append(info.ll)
            xs.append(state.x)
            ws.append(state.w)
            wes.append(state.we)
            state = self.predict(state, u_seq[k], p, tk)
        _record("forward_trajectory", "sequential")
        return ParticleFilteringSolution(
            u=u_seq, y=y, x=torch.stack(xs), w=torch.stack(ws),
            we=torch.stack(wes), ll=torch.stack(lls).sum(),
            route="sequential")

    def loglik(self, u, y, p=None, *,
               generator: Optional[torch.Generator] = None,
               state0: PFState = None, method: str = "auto"):
        """Total log-likelihood.  ``method="auto"`` on CUDA tensors runs
        the whole recursion as kernel A when the filter is admitted
        (routing.route_pf_loglik); otherwise, and for
        ``method="sequential"``, the step loop, which autograd can
        differentiate."""
        from ..routing import route_pf_loglik

        routed = route_pf_loglik(self, u, y, p, generator, state0, method)
        if routed is not None:
            return routed
        T = y.shape[0]
        u_seq = _as_u_seq(u, T, y.dtype, y.device)
        p = self.p if p is None else p
        state = self.init(generator) if state0 is None else state0
        ll = y.new_zeros(())
        for k in range(T):
            state, info = self.update(state, u_seq[k], y[k], p, k * self.Ts)
            ll = ll + info.ll
        return ll

    def smooth(self, u, y, p=None, *, M: int,
               generator: Optional[torch.Generator] = None,
               backend: str = "auto"):
        """FFBS particle smoother: :meth:`forward_trajectory`, then
        ``smoothing.ffbs_smooth`` (kernel J on CUDA float32 data), both
        drawing from ``generator``.  Returns ``(xb [T, M, nx], ll)``."""
        from ..smoothing import ffbs_smooth

        sol = self.forward_trajectory(u, y, p, generator=generator)
        return ffbs_smooth(self, sol, M, generator, u=u, y=y, p=p,
                           backend=backend)

    def weighted_mean(self, state: PFState) -> torch.Tensor:
        return torch.einsum("n,nd->d", state.we, state.x)

    def effective_particles(self, state: PFState) -> torch.Tensor:
        return effective_particles(state.we)

    def sample_initial(self, generator, p=None, noise=True):
        d0 = self.initial_density
        return d0.sample(generator) if noise else d0.mean

    def sample_state(self, generator, x, u, p=None, t=0, noise=True):
        xn = self.dynamics(x, u, p, t)
        if noise and self.dynamics_density is not None:
            xn = xn + self.dynamics_density.sample(generator)
        return xn

    def sample_measurement(self, generator, x, u, p=None, t=0, noise=True):
        y = self.measurement(x, u, p, t)
        if noise and self.measurement_density is not None:
            y = y + self.measurement_density.sample(generator)
        return y

