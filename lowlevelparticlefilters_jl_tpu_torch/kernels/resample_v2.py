"""Systematic resample index + gather, kernel E (counterpart of
``ops/pallas/resample_v2.py``).

``fused_systematic_gather(x, we, generator)`` returns ``(x[j], j)`` with
``j = resample_systematic(we)``: the slot boundaries ``K`` come from
``ops/resample.py::_systematic_slots`` outside the kernel, as the JAX
entry computes them in XLA, and one launch writes both the int32 indices
and the gathered rows (csrc/resample_v2.cu).  The TPU formulation (the
windowed 0/1 MXU contractions, the bf16 hi/mid/lo split, the 8-aligned
window bases and the VMEM envelope ``_kernel_fits``) is not ported.
"""
from __future__ import annotations

import torch

from ..ops.resample import _systematic_slots, _uniform
from ._lib import KernelInfo, check, library, stream_ptr
from .resample_route import slot_sources

SYSTEMATIC_INDEX_GATHER = KernelInfo(
    "systematic_index_gather",
    "lowlevelparticlefilters_jl_tpu_torch/csrc/resample_v2.cu",
    "lowlevelparticlefilters_jl_tpu/ops/pallas/resample_v2.py:182")


def systematic_index_gather_plain(x: torch.Tensor, K: torch.Tensor):
    j = slot_sources(K)
    return x[j], j.to(torch.int32)


def systematic_index_gather(x: torch.Tensor, K: torch.Tensor):
    """``(x[j], j)`` with ``j_k = min(#{i : K_i <= k}, N - 1)`` for
    ``x [N, nx]`` (float32 or float64) and slot boundaries ``K [N]``
    (int32, non-decreasing); ``j`` is int32."""
    if not x.is_cuda:
        return systematic_index_gather_plain(x, K)
    if x.ndim != 2 or x.dtype not in (torch.float32, torch.float64):
        raise TypeError("systematic_index_gather: x must be [N, nx] float32 "
                        "or float64")
    N, nx = x.shape
    if not K.is_cuda or K.dtype != torch.int32 or tuple(K.shape) != (N,):
        raise ValueError("systematic_index_gather: K must be a CUDA int32 "
                         "[N] tensor")
    if x.requires_grad:
        raise RuntimeError("systematic_index_gather is forward-only")
    x = x.contiguous()
    K = K.contiguous()
    out = torch.empty_like(x)
    j = torch.empty(N, dtype=torch.int32, device=x.device)
    check(library().lib.llpf_systematic_index_gather(
        x.data_ptr(), K.data_ptr(), out.data_ptr(), j.data_ptr(), N, nx,
        x.element_size(), stream_ptr(x)), "systematic_index_gather")
    SYSTEMATIC_INDEX_GATHER.launches += 1
    return out, j


def fused_systematic_gather(x: torch.Tensor, we: torch.Tensor,
                            generator=None, *, r=None):
    """Systematic resample + gather, bitwise equal to
    ``x[resample_systematic(we)]``: returns ``(x[j], j)``.  The offset
    ``r`` is drawn from ``generator`` unless given (as the JAX tests pass
    the JAX draw)."""
    r = _uniform(generator, (), we) if r is None else r
    return systematic_index_gather(x, _systematic_slots(we, r, we.shape[-1]))
