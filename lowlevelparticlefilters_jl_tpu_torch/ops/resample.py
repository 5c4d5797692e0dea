"""Particle resampling (counterpart of ``ops/resample.py``).

Systematic resampling derives every index from the slot boundaries
``K_i = ceil(cdf_i * M / total - r)``: particle i fills output slots
``[K_{i-1}, K_i)``.  Where the JAX package takes a PRNG key, these take
a ``torch.Generator`` or, for exact comparison, the offset ``r`` itself.
"""
from __future__ import annotations

from typing import Literal, Optional

import torch

from ..kernels.resample_route import slot_sources, systematic_gather

ResamplingStrategy = Literal["systematic", "stratified", "residual",
                             "multinomial"]


def _uniform(generator, shape, like: torch.Tensor) -> torch.Tensor:
    return torch.rand(shape, generator=generator, dtype=like.dtype,
                      device=like.device)


_ROW = 1024


def _cumsum(w: torch.Tensor) -> torch.Tensor:
    """``torch.cumsum(w, -1)``, summed in a fixed order on the card too.

    PyTorch scans a 1-D CUDA tensor with CUB's single-pass scan, whose
    decoupled look-back takes a tile's prefix from whichever earlier
    partial sums have been published, so the order of the additions, and
    the last bit of the result, changes from call to call.  A changed
    bit can move a slot boundary K and so the resampled cloud.  Here the
    weights are scanned as rows of a [≥2, 1024] view (PyTorch's per-row
    scan, one fixed order), and the row totals likewise, as the first
    row of a [2, rows] view.  The slot boundaries of the weights that
    kernel E takes on the card come from its slot stage instead
    (:func:`_systematic_slots`); those beyond it (N > 2^24, float16) and
    the particle-sharded PF's global prefix (parallel/sharded.py) keep
    this one."""
    if not w.is_cuda or w.ndim != 1:
        return torch.cumsum(w, -1)
    n = w.shape[0]
    rows = max(2, -(-n // _ROW))
    wp = w.new_zeros(rows * _ROW)
    wp[:n] = w
    part = wp.view(rows, _ROW).cumsum(1)
    tot = w.new_zeros(2, rows)
    tot[0] = part[:, -1]
    before = tot.cumsum(1)[0]                  # inclusive: rows 0..i
    part[1:] += before[:-1, None]
    return part.view(-1)[:n]


def _systematic_slots(we: torch.Tensor, r: torch.Tensor, M: int
                      ) -> torch.Tensor:
    """Per-particle slot boundaries K (int32, non-decreasing, in [0, M]).

    A floating-point cumsum is not monotone under rounding for heavily
    skewed weights, so K is repaired with a running max, as in the JAX
    package; every gather assumes sorted K.  Weights on the card that
    kernel E takes (``resample_v2.kernel_takes``: 1-D, float32 or float64,
    N <= 2^24) take its slot stage (kernels/resample_v2.py), the
    arithmetic of E's whole resample, so kernel B's gather and E give the
    same cloud; K, an integer function of the weights, carries no
    gradient.  Other weights (batched, float16, or beyond E's N) take
    :func:`_cumsum`, as on the CPU."""
    if we.is_cuda:
        from ..kernels.resample_v2 import kernel_takes, systematic_slots

        if kernel_takes(we.shape, we.dtype):
            return systematic_slots(we.detach(), r, M)
    bins = _cumsum(we)
    total = bins[..., -1:]
    K = torch.ceil(bins * M / total - r).to(torch.int32)
    K = torch.cummax(K, dim=-1).values
    return K.clamp(0, M)


def resample_systematic(we: torch.Tensor, generator=None,
                        M: Optional[int] = None, *, r=None) -> torch.Tensor:
    """Systematic resampling indices ``j`` [M] (int64)."""
    M = we.shape[-1] if M is None else M
    r = _uniform(generator, (), we) if r is None else r
    return slot_sources(_systematic_slots(we, r, M), M)


def resample_systematic_gather(x: torch.Tensor, we: torch.Tensor,
                               generator=None, *, r=None) -> torch.Tensor:
    """``x[resample_systematic(we)]``.  On a CUDA tensor the gather is
    kernel B (kernels/resample_route.py); the result is bitwise equal."""
    r = _uniform(generator, (), we) if r is None else r
    return systematic_gather(x, _systematic_slots(we, r, we.shape[-1]))


def resample_stratified(we: torch.Tensor, generator=None,
                        M: Optional[int] = None) -> torch.Tensor:
    """Stratified resampling: one uniform per stratum."""
    N = we.shape[-1]
    M = N if M is None else M
    bins = torch.cumsum(we, dim=-1)
    u = (torch.arange(M, dtype=we.dtype, device=we.device)
         + _uniform(generator, (M,), we)) / M * bins[-1]
    return torch.searchsorted(bins, u, right=True).clamp_(0, N - 1)


def resample_multinomial(we: torch.Tensor, generator=None,
                         M: Optional[int] = None) -> torch.Tensor:
    """I.i.d. categorical draws."""
    M = we.shape[-1] if M is None else M
    return torch.multinomial(we, M, replacement=True, generator=generator)


def resample_residual(we: torch.Tensor, generator=None,
                      M: Optional[int] = None) -> torch.Tensor:
    """Residual resampling: ``floor(M we_i)`` deterministic copies, the
    remaining slots drawn from the residual weights."""
    N = we.shape[-1]
    M = N if M is None else M
    nw = we / we.sum() * M
    cnt = torch.floor(nw)
    resid = nw - cnt
    num_det = int(cnt.sum())
    slots = torch.arange(M, dtype=we.dtype, device=we.device)
    j_det = torch.searchsorted(torch.cumsum(cnt, -1), slots, right=True)
    rbins = torch.cumsum(resid / resid.sum().clamp_min(
        torch.finfo(we.dtype).tiny), -1)
    j_res = torch.searchsorted(rbins, _uniform(generator, (M,), we),
                               right=True)
    j = torch.where(slots < num_det, j_det, j_res)
    return j.clamp_(0, N - 1)


_RESAMPLERS = {
    "systematic": resample_systematic,
    "stratified": resample_stratified,
    "residual": resample_residual,
    "multinomial": resample_multinomial,
}


def resample(we: torch.Tensor, generator=None, M: Optional[int] = None,
             strategy: ResamplingStrategy = "systematic") -> torch.Tensor:
    """Dispatch on the strategy name."""
    try:
        fn = _RESAMPLERS[strategy]
    except KeyError:
        raise ValueError(f"unknown resampling strategy {strategy!r}") from None
    return fn(we, generator, M)


def resample_gather(x: torch.Tensor, we: torch.Tensor, generator=None,
                    strategy: ResamplingStrategy = "systematic",
                    exact: bool = False, *, r=None) -> torch.Tensor:
    """``x[resample(we)]`` as the particle filters resample: systematic
    through kernel B's gather, or with ``exact`` through kernel E, which
    goes from the weights to the index vector ``j`` and the rows ``x[j]``
    in one launch (the JAX package's ``exact_resample`` branch); the two
    draw the same r and compute the same K, so their results are bitwise
    equal.  A systematic resample takes the offset ``r`` where it is
    given, else draws it from ``generator``.  Other strategies index, and
    so does systematic resampling of particles that autograd records
    (``routing._needs_grad``): the kernels are forward-only."""
    from ..routing import _needs_grad

    if strategy != "systematic":
        return x[resample(we, generator, x.shape[0], strategy=strategy)]
    if _needs_grad(x):
        return x[resample_systematic(we, generator, x.shape[0], r=r)]
    if exact:
        from ..kernels.resample_v2 import fused_systematic_gather

        return fused_systematic_gather(x, we, generator, r=r)[0]
    return resample_systematic_gather(x, we, generator, r=r)
