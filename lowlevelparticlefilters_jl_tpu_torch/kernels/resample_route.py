"""Systematic resample + gather, kernel B (counterpart of
``ops/pallas/resample_route.py``).

``systematic_gather(x, K)`` returns ``x[j]`` with ``j_k = #{i : K_i <= k}``
clipped to N - 1, where ``K`` are the non-decreasing slot boundaries of
``ops/resample.py::_systematic_slots``.  The TPU kernel's [8, NL] plane
layout and its three log-shift routing phases are not ported: on the card
each block takes an equal share of the merged boundaries and slots (a
merge-path search, ``csrc/slots.cuh``), reads its boundaries once into
shared memory, and copies its slots' rows (``csrc/resample_route.cu``).
"""
from __future__ import annotations

import torch

from ._lib import KernelInfo, check, library, stream_ptr

SYSTEMATIC_GATHER = KernelInfo(
    "systematic_gather",
    "lowlevelparticlefilters_jl_tpu_torch/csrc/resample_route.cu",
    "lowlevelparticlefilters_jl_tpu/ops/pallas/resample_route.py:302")


def slot_sources(K: torch.Tensor, M: int | None = None) -> torch.Tensor:
    """``j_k = #{i : K_i <= k}`` for k < M, clipped to [0, N - 1]."""
    N = K.shape[-1]
    M = N if M is None else M
    k = torch.arange(M, dtype=K.dtype, device=K.device)
    return torch.searchsorted(K, k, right=True).clamp_(max=N - 1)


def systematic_gather_plain(x: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    return x[slot_sources(K)]


def systematic_gather(x: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """``x [N, nx]`` resampled by the slot boundaries ``K [N]`` (int32)."""
    if not x.is_cuda:
        return systematic_gather_plain(x, K)
    if x.ndim != 2 or x.dtype not in (torch.float32, torch.float64):
        raise TypeError("systematic_gather: x must be [N, nx] float32 or "
                        "float64")
    N, nx = x.shape
    if not K.is_cuda or K.dtype != torch.int32 or tuple(K.shape) != (N,):
        raise ValueError("systematic_gather: K must be a CUDA int32 [N] "
                         "tensor")
    if x.requires_grad:
        raise RuntimeError("systematic_gather is forward-only")
    x = x.contiguous()
    K = K.contiguous()
    out = torch.empty_like(x)
    check(library().lib.llpf_systematic_gather(
        x.data_ptr(), K.data_ptr(), out.data_ptr(), N, nx, x.element_size(),
        stream_ptr(x)), "systematic_gather")
    SYSTEMATIC_GATHER.launches += 1
    return out
