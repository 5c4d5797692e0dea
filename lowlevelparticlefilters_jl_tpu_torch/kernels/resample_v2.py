"""Systematic resample from the weights to the resampled cloud, kernel E
(counterpart of ``ops/pallas/resample_v2.py``).

``fused_systematic_gather(x, we, generator)`` returns ``(x[j], j)`` with
``j = resample_systematic(we)``.  On CUDA tensors one cooperative launch
(``csrc/resample_v2.cu``) forms the weights' prefix sum, the slot
boundaries ``K``, the int32 indices and the gathered rows
(:func:`systematic_resample`), after the one ``torch.rand`` of the offset
r, which stays on the card.  A second entry of the same source stops at
``K`` (:func:`systematic_slots`); ``ops/resample.py::_systematic_slots``
takes it on the card, so kernel B's gather and this resample start from
the same ``K`` and give the same bits.

The prefix is summed in one fixed order, written out in PyTorch ops by
:func:`runs_prefix`, and the twins :func:`systematic_slots_plain` and
:func:`systematic_resample_plain` repeat the kernel's arithmetic op for
op: they are the kernel's bitwise references on any device.  CPU tensors
keep ``torch.cumsum`` (``_systematic_slots``' CPU path, which equals the
JAX package's bit for bit); the two orders differ by at most a rounding
of the prefix, which can move a slot boundary where a value lies within
an ulp of an integer.  The TPU formulation (the windowed 0/1 MXU
contractions, the bf16 hi/mid/lo split, the 8-aligned window bases and
the VMEM envelope ``_kernel_fits``) is not ported.
"""
from __future__ import annotations

import torch

from ..ops.resample import _systematic_slots, _uniform
from ._lib import KernelInfo, check, library, stream_ptr
from .resample_route import slot_sources, systematic_gather

_SRC = "lowlevelparticlefilters_jl_tpu_torch/csrc/resample_v2.cu"
_JAX = "lowlevelparticlefilters_jl_tpu/ops/pallas/resample_v2.py:182"
SYSTEMATIC_RESAMPLE = KernelInfo("systematic_resample", _SRC, _JAX)
#: the slot stage alone (kernel B's route): the same source and arithmetic
SYSTEMATIC_SLOTS = KernelInfo("systematic_slots", _SRC, _JAX)

RUN = 32             # values a run of the prefix's summation order
MAX_N = 1 << 24      # the kernel's N: its scans keep N / 1024 sums on chip


def kernel_takes(shape, dtype) -> bool:
    """Whether kernel E takes weights of this shape and dtype: 1-D,
    float32 or float64, 1 <= N <= :data:`MAX_N`.  ``ops/resample.py``
    routes by it, and :func:`_weights` admits by it, so the route and the
    kernel's checks agree.  Other weights take ``_cumsum``'s slot
    boundaries and kernel B's gather: a route chosen by size and dtype,
    as the JAX package admits its kernels by their envelopes."""
    return (len(shape) == 1 and dtype in (torch.float32, torch.float64)
            and 1 <= shape[0] <= MAX_N)


def runs_prefix(v: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of the 1-D float64 ``v`` in kernel E's order:
    runs of :data:`RUN` consecutive values summed left to right (a run
    padded with zeros), the runs' totals scanned by this same rule, and
    each value's partial sum in its run added to the inclusive prefix of
    the runs before it (zero for the first run)."""
    n = v.shape[0]
    rows = -(-n // RUN)
    m = v.new_zeros(rows * RUN)
    m[:n] = v
    m = m.view(rows, RUN)
    part = torch.empty_like(m)
    acc = v.new_zeros(rows)
    for c in range(RUN):
        acc = acc + m[:, c]
        part[:, c] = acc
    if rows == 1:
        return part.view(-1)[:n]
    before = runs_prefix(part[:, -1].contiguous())
    off = torch.cat([v.new_zeros(1), before[:-1]])
    return (off[:, None] + part).view(-1)[:n]


def systematic_index_gather_plain(x: torch.Tensor, K: torch.Tensor):
    """``(x[j], j)`` (j int32) for the slot boundaries ``K``."""
    j = slot_sources(K)
    return x[j], j.to(torch.int32)


def systematic_slots_plain(we: torch.Tensor, r, M: int) -> torch.Tensor:
    """The twin of :func:`systematic_slots`: ``K`` (int32 [N]) from the
    prefix of :func:`runs_prefix` rounded once to ``we``'s dtype, then
    ``ceil(cdf * M / total - r)`` in separate ops, the running max and the
    clamp to [0, M]."""
    bins = runs_prefix(we.double()).to(we.dtype)
    total = bins[-1:]
    r = torch.as_tensor(r, device=we.device).to(we.dtype)
    K = torch.ceil(bins * M / total - r).to(torch.int32)
    return torch.cummax(K, 0).values.clamp(0, M)


def systematic_resample_plain(x: torch.Tensor, we: torch.Tensor, r):
    """The twin of :func:`systematic_resample`: ``(x[j], j)``."""
    return systematic_index_gather_plain(
        x, systematic_slots_plain(we, r, x.shape[0]))


def _weights(we: torch.Tensor, r, N: int, what: str):
    """Kernel E's checks of the weights and the offset; returns them as
    the kernel reads them (16-byte aligned; r a device scalar of their
    dtype)."""
    if not kernel_takes(we.shape, we.dtype) or we.shape[0] != N:
        if we.dtype not in (torch.float32, torch.float64) or we.ndim != 1:
            raise TypeError(f"{what}: the weights must be a 1-D float32 or "
                            "float64 tensor")
        raise ValueError(f"{what}: N = {we.shape[0]} weights, kernel E "
                         f"takes 1 to {MAX_N}")
    if we.requires_grad:
        raise RuntimeError(f"{what} is forward-only")
    we = we.contiguous()
    if we.data_ptr() % 16:
        we = we.clone()
    if not (isinstance(r, torch.Tensor) and r.device == we.device
            and r.dtype == we.dtype and r.numel() == 1):
        r = torch.as_tensor(r, device=we.device).to(we.dtype)
    return we, r


def scratch_bytes(N: int) -> int:
    """Bytes of device scratch a call at N weights takes (csrc/
    resample_v2.cu's ``sizes_of``): each lane run's total and partial
    (float64, one a 32 weights), then the raw K and each warp run's max
    (int32, one a 1024 weights)."""
    n1 = -(-N // RUN)
    return 16 * n1 + 4 * (-(-N // 4) * 4 + -(-n1 // 32))


def _scratch(N: int, like: torch.Tensor) -> torch.Tensor:
    return torch.empty(-(-scratch_bytes(N) // 8), dtype=torch.float64,
                       device=like.device)


def _stats(stats):
    if stats is None:
        return None
    if not stats.is_cuda or stats.dtype != torch.int64 \
            or stats.numel() != len(STAMPS):
        raise ValueError(f"stats must be a CUDA int64 [{len(STAMPS)}] tensor")
    return stats.data_ptr()


#: the kernel's phase boundaries that ``stats=`` receives (block 0's
#: ``clock64``): start, lane sums, grid sync 1, the warp runs' prefix, raw
#: K, grid sync 2, the warp runs' maxes, end
STAMPS = ("start", "lane_sums", "sync1", "prefix", "raw_k", "sync2",
          "run_max", "end")


def systematic_slots(we: torch.Tensor, r, M: int, *, stats=None
                     ) -> torch.Tensor:
    """Kernel E's slot stage: the slot boundaries ``K`` (int32 [N],
    non-decreasing, in [0, M]) of the normalised weights ``we`` [N]
    (float32 or float64) at the offset ``r`` (a device scalar).  With
    ``stats`` (CUDA int64 [8]) the kernel writes block 0's ``clock64`` at
    the :data:`STAMPS`."""
    if not we.is_cuda:
        return systematic_slots_plain(we, r, M)
    N = we.shape[-1]
    we, r = _weights(we, r, N, "systematic_slots")
    K = torch.empty(N, dtype=torch.int32, device=we.device)
    scratch = _scratch(N, we)
    check(library().lib.llpf_systematic_slots(
        we.data_ptr(), r.data_ptr(), K.data_ptr(), scratch.data_ptr(),
        scratch.numel() * 8, _stats(stats), N, int(M), we.element_size(),
        stream_ptr(we)), "systematic_slots")
    SYSTEMATIC_SLOTS.launches += 1
    return K


def systematic_resample(x: torch.Tensor, we: torch.Tensor, r, *,
                        stats=None):
    """Kernel E: ``(x[j], j)`` for ``x [N, nx]`` (float32 or float64), the
    normalised weights ``we [N]`` and the offset ``r``; ``j`` is int32.
    ``stats`` as for :func:`systematic_slots`."""
    if not x.is_cuda:
        return systematic_resample_plain(x, we, r)
    if x.ndim != 2 or x.dtype not in (torch.float32, torch.float64):
        raise TypeError("systematic_resample: x must be [N, nx] float32 or "
                        "float64")
    N, nx = x.shape
    if x.requires_grad:
        raise RuntimeError("systematic_resample is forward-only")
    if not we.is_cuda or we.device != x.device:
        raise ValueError("systematic_resample: the weights must lie on x's "
                         "device")
    we, r = _weights(we, r, N, "systematic_resample")
    x = x.contiguous()
    out = torch.empty_like(x)
    j = torch.empty(N, dtype=torch.int32, device=x.device)
    scratch = _scratch(N, x)
    check(library().lib.llpf_systematic_resample(
        we.data_ptr(), r.data_ptr(), x.data_ptr(), out.data_ptr(),
        j.data_ptr(), scratch.data_ptr(), scratch.numel() * 8,
        _stats(stats), N, nx * x.element_size() // 4, we.element_size(),
        stream_ptr(x)), "systematic_resample")
    SYSTEMATIC_RESAMPLE.launches += 1
    return out, j


def fused_systematic_gather(x: torch.Tensor, we: torch.Tensor,
                            generator=None, *, r=None):
    """Systematic resample + gather, bitwise equal to
    ``x[resample_systematic(we)]``: returns ``(x[j], j)``, j int32.  The
    offset ``r`` is drawn from ``generator`` unless given (as the JAX
    tests pass the JAX draw).  Kernel E on CUDA tensors where it takes the
    weights (:func:`kernel_takes`); other weights on the card (N above
    :data:`MAX_N`, float16) take ``ops/resample.py::_systematic_slots``'
    ``_cumsum`` boundaries, kernel B's gather and ``slot_sources(K)``; on
    the CPU the slot boundaries of ``_systematic_slots`` and the gather's
    twin."""
    r = _uniform(generator, (), we) if r is None else r
    if x.is_cuda and kernel_takes(we.shape, we.dtype):
        # j, an integer function of the weights, carries no gradient
        return systematic_resample(x, we.detach(), r)
    K = _systematic_slots(we, r, we.shape[-1])
    if x.is_cuda:
        return systematic_gather(x, K), slot_sources(K).to(torch.int32)
    return systematic_index_gather_plain(x, K)
