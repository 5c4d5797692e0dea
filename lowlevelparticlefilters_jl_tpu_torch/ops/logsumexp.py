"""Stable log-sum-exp weight normalization (counterpart of
``ops/logsumexp.py``)."""
from __future__ import annotations

import torch


def logsumexp_normalize(w: torch.Tensor, axis: int = -1):
    """Normalize log-weights ``w``; return ``(w_norm, we, ll)``.

    - ``w_norm``: log-weights shifted so that ``logsumexp(w_norm) == 0``
    - ``we``: normalized exp-weights, ``sum(we) == 1``
    - ``ll``: ``logsumexp(w)`` of the incoming weights
    """
    offset = torch.amax(w, dim=axis, keepdim=True).detach()
    shifted = w - offset
    we = torch.exp(shifted)
    s = we.sum(dim=axis, keepdim=True)
    ll = torch.log(s) + offset
    w_norm = shifted - torch.log(s)
    we = we / s
    return w_norm, we, ll.squeeze(axis)


def logsumexp(w: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Plain stable ``log(sum(exp(w)))``."""
    offset = torch.amax(w, dim=axis, keepdim=True)
    offset = torch.where(torch.isfinite(offset), offset,
                         torch.zeros_like(offset))
    s = torch.exp(w - offset).sum(dim=axis)
    return torch.log(s) + offset.squeeze(axis)


def expnormalize(w: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """``exp(w) / sum(exp(w))`` computed stably."""
    we = torch.exp(w - torch.amax(w, dim=axis, keepdim=True))
    return we / we.sum(dim=axis, keepdim=True)


def effective_particles(we: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Effective sample size ``1 / sum(we^2)``."""
    return 1.0 / torch.square(we).sum(dim=axis)
