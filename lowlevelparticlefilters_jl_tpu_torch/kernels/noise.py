"""Gaussian noise kernels (counterpart of ``ops/pallas/noise.py``).

- :func:`normal` — kernel C, standard normals (``pallas_normal``),
- :func:`add_gaussian_noise` — kernel D, ``xn + z @ cholᵀ`` with z drawn
  in the kernel (``propagate_gaussian``); ``xn = dyn(x)`` is computed by
  the caller in PyTorch, because a compiled kernel cannot take a Python
  callback.

Both draw Philox4x32-10 (``csrc/philox.cuh``) keyed by a 64-bit seed,
with counter (row, step, dim // 4, tag).  The plain twins below compute
the same generator in int64 tensor arithmetic, so on any device they
draw the same bits as the kernels.  A CUDA tensor goes to the kernel; a
CPU tensor to the plain twin.
"""
from __future__ import annotations

import torch

from ._lib import (KernelInfo, check, default_device, library,
                   require_cuda_f32, stream_ptr)

TAG_NORMAL, TAG_PROPAGATE, TAG_INIT, TAG_RESAMPLE = 1, 2, 3, 4

NORMAL = KernelInfo(
    "normal", "lowlevelparticlefilters_jl_tpu_torch/csrc/noise.cu",
    "lowlevelparticlefilters_jl_tpu/ops/pallas/noise.py:70")
ADD_GAUSSIAN_NOISE = KernelInfo(
    "add_gaussian_noise",
    "lowlevelparticlefilters_jl_tpu_torch/csrc/noise.cu",
    "lowlevelparticlefilters_jl_tpu/ops/pallas/noise.py:171")

_MASK = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_TWO_M24 = 5.9604644775390625e-08
_TWO_PI = 6.283185307179586


def _mulhilo(a: torch.Tensor, m: int):
    """(hi, lo) words of the 64-bit product of uint32 values ``a``
    (held in int64) and the constant ``m``, without leaving int64: the
    product is split over the 16-bit halves of ``m``."""
    p_lo = a * (m & 0xFFFF)
    p_hi = a * (m >> 16)
    t = ((p_hi & 0xFFFF) << 16) + p_lo
    return (p_hi >> 16) + (t >> 32), t & _MASK


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 of the counter words (int64 tensors holding uint32
    values) under key (k0, k1); returns four int64 word tensors."""
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def split_seed(seed: int) -> tuple[int, int]:
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return seed & _MASK, seed >> 32


def uniform_co(b: torch.Tensor) -> torch.Tensor:
    """24-bit uniform in [0, 1), exact in f32."""
    return (b >> 8).to(torch.float32) * _TWO_M24


def _box_muller(b0, b1):
    u1 = ((b0 >> 8) + 1).to(torch.float32) * _TWO_M24
    u2 = uniform_co(b1)
    r = torch.sqrt(-2.0 * torch.log(u1))
    th = _TWO_PI * u2
    return r * torch.cos(th), r * torch.sin(th)


def normals_plain(seed: int, tag: int, step: int, rows: int, cols: int,
                  device=None) -> torch.Tensor:
    """[rows, cols] f32 normals: entry (i, e) is lane e % 4 of the Philox
    call at counter (i, step, e // 4, tag) — the kernels' layout."""
    k0, k1 = split_seed(seed)
    nblk = -(-cols // 4)
    i = torch.arange(rows, dtype=torch.int64, device=device)
    c0 = i.repeat_interleave(nblk)
    c2 = torch.arange(nblk, dtype=torch.int64, device=device).repeat(rows)
    c1 = torch.full_like(c0, int(step) & _MASK)
    c3 = torch.full_like(c0, int(tag))
    b = philox4x32_10(c0, c1, c2, c3, k0, k1)
    n0, n1 = _box_muller(b[0], b[1])
    n2, n3 = _box_muller(b[2], b[3])
    z = torch.stack([n0, n1, n2, n3], -1).reshape(rows, nblk * 4)
    return z[:, :cols]


def resample_offset_plain(seed: int, step: int, device=None) -> torch.Tensor:
    """The systematic-resampling offset r of step ``step`` (f32 scalar)."""
    k0, k1 = split_seed(seed)
    z = torch.zeros((), dtype=torch.int64, device=device)
    b0 = philox4x32_10(z, z + (int(step) & _MASK), z, z + TAG_RESAMPLE,
                       k0, k1)[0]
    return uniform_co(b0)


# -- kernel C: normal -------------------------------------------------------

def normal_plain(seed: int, n: int, *, tag: int = TAG_NORMAL, step: int = 0,
                 device=None) -> torch.Tensor:
    """Flat stream of ``n`` normals: element k is lane k % 4 of row
    k // 4."""
    return normals_plain(seed, tag, step, -(-n // 4), 4,
                         device=device).reshape(-1)[:n]


def normal(seed: int, shape, *, tag: int = TAG_NORMAL, step: int = 0,
           device=None) -> torch.Tensor:
    """Standard normals of ``shape`` (f32) from (seed, tag, step), on
    ``device`` (default: the card; raises without one)."""
    shape = tuple(shape)
    n = 1
    for s in shape:
        n *= int(s)
    device = default_device(device)
    if device.type != "cuda":
        return normal_plain(seed, n, tag=tag, step=step,
                            device=device).reshape(shape)
    out = torch.empty(shape, dtype=torch.float32, device=device)
    check(library().lib.llpf_normal(out.data_ptr(), n, int(seed) & (2**64 - 1),
                                    tag, int(step) & _MASK, stream_ptr(out)),
          "normal")
    NORMAL.launches += 1
    return out


# -- kernel D: add_gaussian_noise -------------------------------------------

def add_gaussian_noise_plain(xn: torch.Tensor, chol: torch.Tensor, seed: int,
                             step: int) -> torch.Tensor:
    N, nx = xn.shape
    z = normals_plain(seed, TAG_PROPAGATE, step, N, nx, device=xn.device)
    return xn + z @ chol.T


def add_gaussian_noise(xn: torch.Tensor, chol: torch.Tensor, seed: int,
                       step: int) -> torch.Tensor:
    """``xn + z @ cholᵀ`` with z [N, nx] Philox normals at (seed, step)."""
    if not xn.is_cuda:
        return add_gaussian_noise_plain(xn, chol, seed, step)
    N, nx = xn.shape
    if nx > 8:
        raise ValueError("add_gaussian_noise: nx must be <= 8")
    xn, chol = xn.contiguous(), chol.contiguous()
    require_cuda_f32("xn", xn)
    require_cuda_f32("chol", chol, (nx, nx))
    out = torch.empty_like(xn)
    check(library().lib.llpf_add_gaussian_noise(
        xn.data_ptr(), chol.data_ptr(), out.data_ptr(), N, nx,
        int(seed) & (2**64 - 1), int(step) & _MASK, stream_ptr(xn)),
        "add_gaussian_noise")
    ADD_GAUSSIAN_NOISE.launches += 1
    return out


# -- raw Philox words, for the known-answer and curand checks ---------------

def philox_bits(counters: torch.Tensor, key: tuple[int, int], *,
                curand: bool = False) -> torch.Tensor:
    """Philox4x32-10 words of ``counters`` [n, 4] (int64 holding uint32)
    under ``key``.  On a CUDA tensor this runs the kernel's device
    function (or, with ``curand=True``, curand's ``curand_Philox4x32_10``)
    and returns int64 words; on the CPU the plain twin."""
    k0, k1 = key
    if not counters.is_cuda:
        if curand:
            raise ValueError("curand's Philox runs on the card only")
        return torch.stack(philox4x32_10(*counters.unbind(-1), k0, k1), -1)
    ctr = counters.to(torch.int32).contiguous()   # same 32 bits
    out = torch.empty_like(ctr)
    fn = (library().lib.llpf_curand_philox_bits if curand
          else library().lib.llpf_philox_bits)
    check(fn(ctr.data_ptr(), ctr.shape[0], k0, k1, out.data_ptr(),
             stream_ptr(ctr)), "philox_bits")
    return out.to(torch.int64) & _MASK
