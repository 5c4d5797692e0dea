"""Filter protocol (counterpart of ``filters/base.py``):

    state       = f.init()
    state, info = f.correct(state, u, y, p, t)
    state       = f.predict(state, u, p, t)
    state, info = f.update(state, u, y, p, t)
"""
from __future__ import annotations

import torch


class AbstractFilter:
    """Mixin with the shared update logic."""

    def init(self, generator=None):  # pragma: no cover - overridden
        raise NotImplementedError

    def predict(self, state, u=None, p=None, t=0, **kw):  # pragma: no cover
        raise NotImplementedError

    def correct(self, state, u, y, p=None, t=0, **kw):  # pragma: no cover
        raise NotImplementedError

    def update(self, state, u, y, p=None, t=0, **kw):
        """One correct-then-predict step."""
        state, info = self.correct(state, u, y, p, t, **kw)
        state = self.predict(state, u, p, t)
        return state, info

    def __call__(self, state, u, y, p=None, t=0, **kw):
        return self.update(state, u, y, p, t, **kw)

    @property
    def dims(self) -> tuple[int, int, int]:
        return (self.nx, self.nu, self.ny)


class AbstractKalmanFilter(AbstractFilter):
    """Marker base for Kalman-family filters (Gaussian posteriors)."""

    def state(self, state):
        return state.x

    def covariance(self, state):
        return state.R


class AbstractParticleFilter(AbstractFilter):
    """Marker base for particle filters (weighted-sample posteriors)."""

    def state(self, state):
        return torch.einsum("n,nd->d", state.we, state.x)
