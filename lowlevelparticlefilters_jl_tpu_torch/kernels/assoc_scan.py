"""Temporal-parallel KF/RTS associative scans, kernel K (counterpart of
``ops/pallas/assoc_scan.py``).

- :func:`filter_scan_p` — inclusive prefix of the filtering elements
  (A, b, C, η, J) under ``parallel.temporal._filter_combine_soa``;
  returns the ``b`` and ``C`` planes (filtered means and covariances),
- :func:`smooth_scan_p` — the reverse scan of the smoothing elements
  (E, g, L) under ``g(a, b) = _smooth_combine_soa(b, a)``, done forward
  over time flipped (the scan runs from the end with the prefix so far
  as the combine's first argument); returns the ``g`` and ``L`` planes,
- :func:`filter_scan_full` — the filter scan returning all five
  combined element stacks ``(A, b, C, η, J)``, the local level of the
  time-sharded scan (parallel/sharded.py).

Elements come in as the plane structures of ``parallel/temporal.py``.  On
CUDA the planes are stacked once into an element-major [T, E] f32
tensor and scanned by ``csrc/assoc_scan.cu`` in one cooperative launch
(runs of consecutive steps a thread, block and grid prefixes in a fixed
tree, so two calls give the same bits); on the CPU the plain twin is the
Hillis–Steele :func:`parallel.temporal.associative_scan` with the same
combine, which is also the route off the kernel's gate.
"""
from __future__ import annotations

import torch

from ..parallel.temporal import (_filter_combine, _filter_combine_soa,
                                 _kernel_takes, _leaves, _m_join, _m_split,
                                 _smooth_combine_soa, _v_join, _v_split,
                                 associative_scan)
from ._lib import KernelInfo, check, library, require_cuda_f32, stream_ptr

_SRC = "lowlevelparticlefilters_jl_tpu_torch/csrc/assoc_scan.cu"
_JAX = "lowlevelparticlefilters_jl_tpu/ops/pallas/assoc_scan.py"
ASSOC_SCAN = KernelInfo("assoc_scan", _SRC, f"{_JAX}:167")
ASSOC_SCAN_FULL = KernelInfo("assoc_scan_full", _SRC, f"{_JAX}:314")

FILTER, SMOOTH = 0, 1
MAX_NX = 8


def scan_supported(nx: int, like: torch.Tensor) -> bool:
    """Kernel K's gate: CUDA, float32, nx <= 8."""
    return like.is_cuda and like.dtype == torch.float32 and nx <= MAX_NX


def n_elements(nx: int, kind: int) -> int:
    """Floats in one element: 3nx² + 2nx (filter), 2nx² + nx (smooth)."""
    return 3 * nx * nx + 2 * nx if kind == FILTER else 2 * nx * nx + nx


def plane_scan(x: torch.Tensor, nx: int, kind: int) -> torch.Tensor:
    """Kernel K on element-major ``x`` [T, E] (CUDA f32): returns the
    inclusive scan's mean and covariance parts [T, nx + nx²] (b, C for the
    filter; g, L for the smoother, scanned in reverse)."""
    T, E = x.shape
    if not 1 <= nx <= MAX_NX or E != n_elements(nx, kind):
        raise ValueError(f"assoc_scan: nx must be 1..{MAX_NX} and E "
                         f"{n_elements(nx, kind)}, got nx={nx}, E={E}")
    require_cuda_f32("elements", x)
    x = _aligned(x)
    out = torch.empty((T, nx + nx * nx), dtype=torch.float32,
                      device=x.device)
    scratch = _scratch(T, E, x)
    check(library().lib.llpf_assoc_scan(
        x.data_ptr(), out.data_ptr(), scratch.data_ptr(), scratch.numel(),
        T, nx, kind, stream_ptr(x)), "assoc_scan")
    ASSOC_SCAN.launches += 1
    return out


def _scratch(T: int, E: int, like: torch.Tensor) -> torch.Tensor:
    # one aggregate a block; the co-resident grid has at most 8192 blocks
    return torch.empty(E * min(T, 8192), dtype=torch.float32,
                       device=like.device)


def _aligned(x: torch.Tensor) -> torch.Tensor:
    # the kernel reads records with 16-byte loads from a 16-byte aligned base
    return x.clone() if x.data_ptr() % 16 else x


def full_scan(x: torch.Tensor, nx: int) -> torch.Tensor:
    """Kernel K's whole-element mode on element-major filter elements
    ``x`` [T, E] (CUDA f32, E = 3nx² + 2nx): the inclusive prefixes,
    whole, [T, E] in a new tensor (``x`` is only read)."""
    T, E = x.shape
    if not 1 <= nx <= MAX_NX or E != n_elements(nx, FILTER):
        raise ValueError(f"assoc_scan_full: nx must be 1..{MAX_NX} and E "
                         f"{n_elements(nx, FILTER)}, got nx={nx}, E={E}")
    require_cuda_f32("elements", x)
    x = _aligned(x)
    out = torch.empty_like(x)
    scratch = _scratch(T, E, x)
    check(library().lib.llpf_assoc_scan_full(
        x.data_ptr(), out.data_ptr(), scratch.data_ptr(), scratch.numel(),
        T, nx, stream_ptr(x)), "assoc_scan_full")
    ASSOC_SCAN_FULL.launches += 1
    return out


def _split_out(out: torch.Tensor, nx: int):
    m = tuple(out[:, i] for i in range(nx))
    M = tuple(tuple(out[:, nx + i * nx + j] for j in range(nx))
              for i in range(nx))
    return m, M


def _kernel_scan(elems_p, kind: int):
    nx = len(elems_p[1])
    if not scan_supported(nx, elems_p[1][0]):
        raise TypeError("assoc_scan: CUDA elements must be float32 with "
                        f"nx <= {MAX_NX}")
    # one record per step: the planes in order, matrices row-major
    x = torch.stack(_leaves(elems_p), -1)
    return _split_out(plane_scan(x, nx, kind), nx)


def filter_scan_p_plain(elems_p):
    _, b, C, _, _ = associative_scan(_filter_combine_soa, elems_p)
    return b, C


def smooth_scan_p_plain(elems_p):
    _, g, L = associative_scan(lambda a, b: _smooth_combine_soa(b, a),
                               elems_p, reverse=True)
    return g, L


def filter_scan_p(elems_p):
    """Filtered moments ``(xt planes [nx], Rt planes [nx][nx])`` of the
    plane elements (A, b, C, η, J)."""
    if not elems_p[1][0].is_cuda:
        return filter_scan_p_plain(elems_p)
    return _kernel_scan(elems_p, FILTER)


def smooth_scan_p(elems_p):
    """Smoothed moments ``(xT planes, RT planes)`` of the plane elements
    (E, g, L), scanned from the end."""
    if not elems_p[1][0].is_cuda:
        return smooth_scan_p_plain(elems_p)
    return _kernel_scan(elems_p, SMOOTH)


def _split(stacks):
    return tuple(_m_split(a) if a.ndim == 3 else _v_split(a)
                 for a in stacks)


def filter_scan(A, b, C, eta, J):
    """[T, ...] element stacks in, ``(xt [T, nx], Rt [T, nx, nx])`` out."""
    m, M = filter_scan_p(_split((A, b, C, eta, J)))
    return _v_join(m), _m_join(M)


def smooth_scan(E, g, L):
    """[T, ...] element stacks in, ``(xT [T, nx], RT [T, nx, nx])`` out."""
    m, M = smooth_scan_p(_split((E, g, L)))
    return _v_join(m), _m_join(M)


def filter_scan_full_plain(A, b, C, eta, J):
    """The twin of :func:`filter_scan_full`: the Hillis–Steele scan under
    ``_filter_combine``, any dtype and device, differentiable."""
    return associative_scan(_filter_combine, (A, b, C, eta, J))


def filter_scan_full(A, b, C, eta, J):
    """Inclusive filter prefix scan of the [T, ...] element stacks,
    returning all five combined stacks ``(A, b, C, eta, J)`` (``b`` and
    ``C`` are the filtered moments).  Kernel K's whole-element mode
    (:func:`full_scan`) on CUDA f32 with nx <= 8 and no tensor that
    autograd records; the twin otherwise, as the JAX package's
    ``scan_supported`` and ``route_ad`` route it."""
    T, nx = b.shape
    elems = (A, b, C, eta, J)
    if not _kernel_takes(nx, elems):
        return filter_scan_full_plain(*elems)
    # one record per step, in the order of the plane elements
    x = torch.cat([e.reshape(T, -1) for e in elems], -1).contiguous()
    out = full_scan(x, nx)
    sizes = [nx * nx, nx, nx * nx, nx, nx * nx]
    return tuple(o.reshape(e.shape)
                 for o, e in zip(out.split(sizes, -1), elems))
