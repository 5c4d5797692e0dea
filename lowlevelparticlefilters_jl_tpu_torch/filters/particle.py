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
- ``"kernel"`` — the initial cloud from kernel C and the propagate step
  as kernel D, the dynamics, the process noise's factor, its draws and
  its mean in one launch (kernels/noise.py, routing.route_pf_propagate;
  the JAX package's ``"pallas"``), each seeded from the generator.

``smooth`` is the FFBS particle smoother (smoothing.py::ffbs_smooth).

:class:`AdvancedParticleFilter` takes non-additive noise: where the JAX
package hands its dynamics a per-particle PRNG key, this one hands it a
per-particle vector of ``noise_dim`` standard normals drawn from the
generator (None for the noiseless propagation).
:class:`AuxiliaryParticleFilter` wraps either filter and folds the next
measurement into first-stage weights.  Systematic resampling gathers
through kernel B, or with ``exact_resample`` through kernel E
(ops/resample.py::resample_gather).
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from ..ops.logsumexp import (effective_particles, expnormalize,
                             logsumexp_normalize)
from ..ops.mvnormal import as_mvnormal
from ..ops.resample import resample_gather
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


class _ParticleCommon(AbstractParticleFilter):
    """Resampling, batch filtering and statistics shared by the particle
    filters."""

    def init(self, generator: Optional[torch.Generator] = None) -> PFState:
        """Draw N initial particles from the initial density."""
        x = self.initial_density.sample(generator, (self.N,))
        w, we = _uniform_weights(self.N, x)
        return PFState(x=x, w=w, we=we, t=0, generator=generator)

    def _maybe_resample(self, state: PFState):
        """Resampled particles and whether the Neff trigger fired."""
        N = self.N
        if self.resample_threshold < 1.0 and not bool(
                effective_particles(state.we) < self.resample_threshold * N):
            return state.x, False
        return resample_gather(state.x, state.we, state.generator,
                               self.resampling_strategy,
                               self.exact_resample), True

    def _weights_after(self, state: PFState, did_resample: bool):
        if did_resample:
            return _uniform_weights(self.N, state.w)
        return state.w, state.we

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
            state = self._advance(state, u_seq, y, k, p, tk)
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

    def _advance(self, state, u_seq, y, k, p, tk):
        return self.predict(state, u_seq[k], p, tk)

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


def _is_density(v) -> bool:
    """A vector density object (MvNormal, TupleProduct, ...), as opposed
    to a covariance matrix."""
    return (hasattr(v, "logpdf") and hasattr(v, "sample")
            and hasattr(v, "dim") and not hasattr(v, "shape"))


def _normalized(state: PFState, w: torch.Tensor, missing):
    """``state`` with log-weights ``w`` normalized (or left as they were
    when the measurement is missing) and the step's ll."""
    w = torch.where(missing, state.w, w)
    w, we, ll = logsumexp_normalize(w)
    return state.replace(w=w, we=we), torch.where(
        missing, torch.zeros_like(ll), ll)


@struct
class ParticleFilter(_ParticleCommon):
    """Bootstrap particle filter with additive noise.

    - ``dynamics``: ``f(x, u, p, t) -> x⁺`` (additive process noise)
    - ``measurement``: ``g(x, u, p, t) -> ŷ`` (additive measurement noise)
    - densities: any vector density object (:class:`MvNormal`,
      ``ops.distributions.TupleProduct``, ...), or a covariance matrix
      (a zero-mean Gaussian)
    - ``exact_resample``: systematic resampling forms the index vector
      and gathers through kernel E instead of kernel B (same result)
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
            if v is not None and not _is_density(v):
                object.__setattr__(self, name, as_mvnormal(v))
        if self.noise_backend not in NOISE_BACKENDS:
            raise ValueError(f"noise_backend must be one of {NOISE_BACKENDS}")

    @property
    def nx(self) -> int:
        return self.initial_density.dim

    def init(self, generator: Optional[torch.Generator] = None) -> PFState:
        """Draw N initial particles from the initial density."""
        if self.noise_backend != "kernel":
            return super().init(generator)
        from ..kernels.noise import TAG_INIT, normal
        from ..routing import seed_from_generator

        d0 = self.initial_density
        z = normal(seed_from_generator(generator), (self.N, self.nx),
                   tag=TAG_INIT, device=d0.mean.device)
        x = d0.mean + z.to(d0.mean.dtype) @ d0.chol().T
        w, we = _uniform_weights(self.N, x)
        return PFState(x=x, w=w, we=we, t=0, generator=generator)

    def correct(self, state: PFState, u, y, p=None, t=None):
        p = self.p if p is None else p
        t = state.t * self.Ts if t is None else t
        g = self.measurement
        yhat = torch.func.vmap(lambda xi: g(xi, u, p, t))(state.x)
        logp = self.measurement_density.logpdf(y - yhat)
        # missing measurements (NaN) leave the weights untouched
        state, ll = _normalized(state, state.w + logp, torch.isnan(y).any())
        return state, PFInfo(ll=ll, e=torch.zeros_like(y))

    def predict(self, state: PFState, u=None, p=None, t=None):
        p = self.p if p is None else p
        t = state.t * self.Ts if t is None else t
        x, did_resample = self._maybe_resample(state)
        d1 = self.dynamics_density
        if d1 is not None and self.noise_backend == "kernel":
            from ..routing import route_pf_propagate

            # kernel D: dynamics, factor, noise and mean in one launch
            xn = route_pf_propagate(self, x, u, p, t, state.generator,
                                    state.t)
        else:
            f = self.dynamics
            xn = torch.func.vmap(lambda xi: f(xi, u, p, t))(x)
            if d1 is not None:
                xn = xn + d1.sample(state.generator, (self.N,))
        w, we = self._weights_after(state, did_resample)
        return PFState(x=xn, w=w, we=we, t=state.t + 1,
                       generator=state.generator)

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


def _std_normals(generator, n: int, dim: int, like: torch.Tensor):
    return torch.randn((n, dim), generator=generator, dtype=like.dtype,
                       device=like.device)


@struct
class AdvancedParticleFilter(_ParticleCommon):
    """Particle filter with non-additive noise.

    - ``dynamics``: ``f(x, u, p, t, noise) -> x⁺``, where ``noise`` is a
      vector of ``noise_dim`` (default nx) standard normals drawn for this
      particle, or None for the noiseless propagation (the reference's
      ``noise::Bool``, the JAX package's ``key is None``)
    - ``measurement``: ``g(x, u, p, t, noise) -> y``, ``noise`` ny standard
      normals or None (used when simulating)
    - ``measurement_likelihood``: ``gl(x, u, y, p, t) -> log p(y | x)``
    """

    N: int
    dynamics: Callable
    measurement: Callable
    measurement_likelihood: Callable
    initial_density: Any = None
    p: Any = None
    resample_threshold: float = 0.5
    resampling_strategy: str = "systematic"
    exact_resample: bool = False
    Ts: float = 1.0
    nu: int = -1
    ny: int = -1
    noise_dim: int = -1

    def __post_init__(self):
        v = self.initial_density
        if v is not None and not _is_density(v):
            object.__setattr__(self, "initial_density", as_mvnormal(v))

    @property
    def nx(self) -> int:
        return self.initial_density.dim

    @property
    def nz(self) -> int:
        """Standard normals a particle's dynamics takes per step."""
        return self.nx if self.noise_dim < 0 else self.noise_dim

    def correct(self, state: PFState, u, y, p=None, t=None,
                g: Callable = None):
        """Weight update by the user likelihood; a custom ``g`` gives a
        per-sensor update."""
        p = self.p if p is None else p
        t = state.t * self.Ts if t is None else t
        gl = self.measurement_likelihood if g is None else g
        logp = torch.func.vmap(lambda xi: gl(xi, u, y, p, t))(state.x)
        state, ll = _normalized(state, state.w + logp, torch.isnan(y).any())
        return state, PFInfo(ll=ll, e=torch.zeros_like(y))

    def propagate(self, x, u, p, t, generator):
        """Every particle through the dynamics with its own noise."""
        z = _std_normals(generator, x.shape[0], self.nz, x)
        f = self.dynamics
        return torch.func.vmap(lambda xi, zi: f(xi, u, p, t, zi))(x, z)

    def predict(self, state: PFState, u=None, p=None, t=None):
        p = self.p if p is None else p
        t = state.t * self.Ts if t is None else t
        x, did_resample = self._maybe_resample(state)
        xn = self.propagate(x, u, p, t, state.generator)
        w, we = self._weights_after(state, did_resample)
        return PFState(x=xn, w=w, we=we, t=state.t + 1,
                       generator=state.generator)

    def sample_initial(self, generator, p=None, noise=True):
        d0 = self.initial_density
        return d0.sample(generator) if noise else d0.mean

    def sample_state(self, generator, x, u, p=None, t=0, noise=True):
        z = _std_normals(generator, 1, self.nz, x)[0] if noise else None
        return self.dynamics(x, u, p, t, z)

    def sample_measurement(self, generator, x, u, p=None, t=0, noise=True):
        if noise and self.ny < 1:
            raise ValueError("set ny to simulate measurement noise")
        z = _std_normals(generator, 1, self.ny, x)[0] if noise else None
        return self.measurement(x, u, p, t, z)


@struct
class AuxiliaryParticleFilter(_ParticleCommon):
    """Auxiliary particle filter around a :class:`ParticleFilter` or an
    :class:`AdvancedParticleFilter`.

    ``predict`` folds the next measurement ``y1`` into first-stage weights
    λ evaluated at the noiselessly propagated particles, resamples by
    them and then propagates with noise; ``correct`` only normalizes.
    ``update(state, u, y, y1)``; ``forward_trajectory`` takes the
    one-step lookahead itself (:meth:`_advance`).  It has no fused
    kernel: its routes are ``sequential``.
    """

    pf: Any

    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, "pf"), name)

    def init(self, generator: Optional[torch.Generator] = None) -> PFState:
        return self.pf.init(generator)

    def correct(self, state: PFState, u, y, p=None, t=None):
        """Normalization only: the measurement enters in predict."""
        w, we, ll = logsumexp_normalize(state.w)
        return state.replace(w=w, we=we), PFInfo(ll=ll,
                                                 e=torch.zeros_like(y))

    def predict(self, state: PFState, u, y1, p=None, t=None):
        inner = self.pf
        p = inner.p if p is None else p
        t = state.t * inner.Ts if t is None else t
        N, gen = inner.N, state.generator
        vm = torch.func.vmap

        def resampled(x, w):
            return resample_gather(x, expnormalize(w), gen,
                                   inner.resampling_strategy,
                                   inner.exact_resample)

        if isinstance(inner, AdvancedParticleFilter):
            xpred = vm(lambda xi: inner.dynamics(xi, u, p, t, None))(state.x)
            lam = vm(lambda xi: inner.measurement_likelihood(
                xi, u, y1, p, t))(xpred)
            x = resampled(state.x, state.w + lam)
            xn = inner.propagate(x, u, p, t, gen)
            w0, we0 = _uniform_weights(N, state.w)
            return PFState(x=xn, w=w0, we=we0, t=state.t + 1, generator=gen)

        f, g = inner.dynamics, inner.measurement
        xpred = vm(lambda xi: f(xi, u, p, t))(state.x)     # noiseless
        lam = inner.measurement_density.logpdf(
            y1 - vm(lambda xi: g(xi, u, p, t))(xpred))
        x = resampled(xpred, state.w + lam)
        if inner.dynamics_density is not None:
            x = x + inner.dynamics_density.sample(gen, (N,))
        # the unresampled λ_i stay on the weights, as in the reference
        w = lam - torch.log(torch.tensor(float(N), dtype=state.w.dtype))
        return PFState(x=x, w=w, we=expnormalize(w), t=state.t + 1,
                       generator=gen)

    def update(self, state, u, y, y1=None, p=None, t=None):
        """One step needs the next measurement ``y1``; with ``y1=None``
        (the last step) only the normalization runs."""
        state, info = self.correct(state, u, y, p, t)
        if y1 is not None:
            state = self.predict(state, u, y1, p, t)
        return state, info

    def _advance(self, state, u_seq, y, k, p, tk):
        """The lookahead: step k's predict takes ``y[k + 1]``; the last
        step has none."""
        if k + 1 == y.shape[0]:
            return state
        return self.predict(state, u_seq[k], y[k + 1], p, tk)

    def loglik(self, u, y, p=None, *,
               generator: Optional[torch.Generator] = None,
               state0: PFState = None, method: str = "auto"):
        """``forward_trajectory(...).ll``; the APF has no fused kernel."""
        from ..routing import _record

        ll = self.forward_trajectory(u, y, p, generator=generator,
                                     state0=state0, method=method).ll
        _record("loglik", "sequential")
        return ll
