"""FFBS backward simulation, kernel J (counterpart of
``ops/pallas/ffbs_kernel.py``).

:func:`ffbs_backward` takes what ``ffbs_backward_pallas`` takes: the
predicted means ``xpred = f(xf_t)`` [T-1, N, nx], the forward log-weights
``wf`` [T-1, N], the forward particles ``xf`` [T-1, N, nx], the terminal
draws ``xb_T`` [M, nx], the lower Cholesky factor of the dynamics noise,
its mean and a seed; it returns the smoothed trajectories ``xb``
[T, M, nx].  The whitening and centring (:func:`whiten`) are plain tensor
code, as the JAX package does them in XLA outside its Pallas kernel; the
backward pass is kernel J (``csrc/ffbs.cu``) on CUDA tensors and its
plain twin :func:`ffbs_backward_plain` on CPU tensors.

Noise: Gumbel(0, 1) from Philox4x32-10 keyed by ``seed``, counter
(n // 4, t, m, ``TAG_FFBS``), lane n % 4, mapped to u strictly inside
(0, 1) (see ``csrc/ffbs.cu``); the twin draws the same words
(:func:`gumbel_plain`), so kernel and twin compare draw for draw.
``noise=False`` selects the exact MAP column, the mode in which the JAX
kernel runs off the TPU (``use_prng=False``).

Not ported from the TPU kernel: the 128-lane and 8-sublane padding and
``NXP = 8``, the dims-major layout, the SMEM scalar block, the one-hot-sum
gather, the ``NC`` lane-chunk sweep with its ``M·Npad <= 2^22`` VMEM
envelope, and the ``M <= 4096``, ``Npad <= 2^18`` caps of its gate.  Kept:
nx <= 8 (the kernel is unrolled per nx and keeps the state in registers)
and the Gaussian density.  Size limits of the port: N < 2^30 and
M < 2^31 (int32 column and block indices).
"""
from __future__ import annotations

import torch

from ..ops.linalg import tri_solve
from ..ops.mvnormal import MvNormal
from ._lib import KernelInfo, check, library, require_cuda_f32, stream_ptr
from .noise import TAG_FFBS, philox4x32_10, split_seed

FFBS_BACKWARD = KernelInfo(
    "ffbs_backward", "lowlevelparticlefilters_jl_tpu_torch/csrc/ffbs.cu",
    "lowlevelparticlefilters_jl_tpu/ops/pallas/ffbs_kernel.py:190")

MAX_DIM = 8
_MAX_N = 1 << 30
_TWO_M24 = 5.9604644775390625e-08


def ffbs_kernel_supported(df, nx: int, like: torch.Tensor) -> bool:
    """Kernel J's gate: a Gaussian ``MvNormal`` dynamics density,
    1 <= nx <= 8 and float32 CUDA particles ``like``."""
    return (isinstance(df, MvNormal) and 1 <= nx <= MAX_DIM and like.is_cuda
            and like.dtype == torch.float32)


def whiten(xpred: torch.Tensor, wf: torch.Tensor, chol: torch.Tensor):
    """The inputs of the backward pass that do not depend on the
    trajectories, in float32: ``zpred = L⁻¹ xpred − c_t`` with ``c_t`` its
    mean over the particles, ``wfc = wf − ½‖zpred‖²``, ``c`` [T-1, nx] and
    ``Linv``.  The backward weight ``wf − ½‖L⁻¹(xb − μ − xpred)‖²`` equals
    ``wfc + zb·zpred − ½‖zb‖²`` with ``zb = L⁻¹(xb − μ) − c_t``; centring
    keeps the three terms O(1), so they do not cancel in float32 for a
    cloud far from the origin (ffbs_kernel.py:223-230)."""
    nx = xpred.shape[-1]
    x = xpred.to(torch.float32)
    L = chol.to(device=x.device, dtype=torch.float32)
    Linv = tri_solve(L, torch.eye(nx, dtype=torch.float32, device=x.device))
    cols = []
    for k in range(nx):  # L⁻¹ is lower triangular
        acc = Linv[k, 0] * x[..., 0]
        for j in range(1, k + 1):
            acc = acc + Linv[k, j] * x[..., j]
        cols.append(acc)
    zpred = torch.stack(cols, -1)
    c = zpred.mean(1)
    zpred = zpred - c[:, None, :]
    wfc = wf.to(torch.float32) - 0.5 * (zpred * zpred).sum(-1)
    return (zpred.contiguous(), wfc.contiguous(), c.contiguous(),
            Linv.contiguous())


def gumbel_plain(seed: int, t: int, M: int, N: int, device=None
                 ) -> torch.Tensor:
    """Kernel J's Gumbel noise of step ``t``, [M, N] float32."""
    k0, k1 = split_seed(seed)
    Q = -(-N // 4)
    q = torch.arange(Q, dtype=torch.int64, device=device).repeat(M)
    m = torch.arange(M, dtype=torch.int64, device=device).repeat_interleave(Q)
    words = philox4x32_10(q, torch.full_like(q, int(t)), m,
                          torch.full_like(q, TAG_FFBS), k0, k1)
    b = torch.stack(words, -1).reshape(M, 4 * Q)[:, :N]
    u = (((b >> 9) << 1) | 1).to(torch.float32) * _TWO_M24
    return -torch.log(-torch.log(u))


def ffbs_backward_plain(zpred, wfc, c, xf, xb_T, Linv, mu, seed: int, *,
                        noise: bool = True, return_indices: bool = False):
    """Kernel J's backward pass as a loop of PyTorch ops, in the kernel's
    order of operations (the arguments as :func:`ffbs_backward_scan`)."""
    Tm1, N, nx = zpred.shape
    M = xb_T.shape[0]
    dev = zpred.device
    xb = xb_T.to(torch.float32)
    outs, idxs = [xb], []
    for t in range(Tm1 - 1, -1, -1):
        cm = torch.zeros(M, dtype=torch.float32, device=dev)
        zb = []
        for k in range(nx):
            acc = torch.zeros(M, dtype=torch.float32, device=dev)
            for j in range(k + 1):
                acc = acc + (xb[:, j] - mu[j]) * Linv[k, j]
            zk = acc - c[t, k]
            cm = cm + zk * zk
            zb.append(zk)
        w = wfc[t].expand(M, N)
        for k in range(nx):
            w = w + zb[k][:, None] * zpred[t, :, k]
        w = w - 0.5 * cm[:, None]
        if noise:
            w = w + gumbel_plain(seed, t, M, N, dev)
        # a NaN never wins; a row without a finite score takes column 0
        w = torch.where(torch.isnan(w), float("-inf"), w)
        i = torch.argmax(w, 1)
        xb = xf[t][i]
        outs.append(xb)
        idxs.append(i.to(torch.int32))
    out = torch.stack(outs[::-1])
    if not return_indices:
        return out
    return out, (torch.stack(idxs[::-1]) if idxs else
                 torch.zeros(0, M, dtype=torch.int32, device=dev))


def ffbs_backward_scan(zpred, wfc, c, xf, xb_T, Linv, mu, seed: int, *,
                       noise: bool = True, return_indices: bool = False):
    """The backward pass on whitened inputs (:func:`whiten`): ``zpred``
    [T-1, N, nx], ``wfc`` [T-1, N], ``c`` [T-1, nx], ``xf`` [T-1, N, nx],
    ``xb_T`` [M, nx], ``Linv`` [nx, nx], ``mu`` [nx].  Returns ``xb``
    [T, M, nx] (and the chosen columns [T-1, M] int32 with
    ``return_indices``).  CUDA tensors launch kernel J; CPU tensors run
    the plain twin."""
    if not zpred.is_cuda:
        return ffbs_backward_plain(zpred, wfc, c, xf, xb_T, Linv, mu, seed,
                                   noise=noise, return_indices=return_indices)
    Tm1, N, nx = zpred.shape
    M = xb_T.shape[0]
    if not (1 <= nx <= MAX_DIM and 1 <= N < _MAX_N and M >= 1):
        raise ValueError(f"ffbs_backward: needs 1 <= nx <= {MAX_DIM}, "
                         f"1 <= N < 2^30, M >= 1 (got nx={nx}, N={N}, M={M})")
    for name, t, shape in (
            ("zpred", zpred, (Tm1, N, nx)), ("wfc", wfc, (Tm1, N)),
            ("c", c, (Tm1, nx)), ("xf", xf, (Tm1, N, nx)),
            ("xb_T", xb_T, (M, nx)), ("Linv", Linv, (nx, nx)),
            ("mu", mu, (nx,))):
        require_cuda_f32(name, t, shape)
    out = torch.empty(Tm1 + 1, M, nx, dtype=torch.float32,
                      device=zpred.device)
    idx = (torch.empty(Tm1, M, dtype=torch.int32, device=zpred.device)
           if return_indices else None)
    check(library().lib.llpf_ffbs_backward(
        zpred.data_ptr(), wfc.data_ptr(), c.data_ptr(), xf.data_ptr(),
        xb_T.data_ptr(), Linv.data_ptr(), mu.data_ptr(), out.data_ptr(),
        idx.data_ptr() if idx is not None else None, Tm1, N, M, nx,
        int(seed) & (2**64 - 1), int(noise), stream_ptr(zpred)),
        "ffbs_backward")
    FFBS_BACKWARD.launches += 1
    return (out, idx) if return_indices else out


def ffbs_backward(xpred, wf, xf, xb_T, chol, mu, seed: int, *,
                  noise: bool = True, return_indices: bool = False):
    """The whole backward-simulation pass of ``ffbs_backward_pallas``:
    whitening (:func:`whiten`), then kernel J on CUDA tensors or its twin
    on CPU tensors.  ``xf`` and ``wf`` are the forward pass's steps
    0..T-2; returns ``xb`` [T, M, nx] with ``xb[T-1] = xb_T``."""
    zpred, wfc, c, Linv = whiten(xpred, wf, chol)
    f32 = lambda t: t.to(device=zpred.device,  # noqa: E731
                         dtype=torch.float32).contiguous()
    return ffbs_backward_scan(zpred, wfc, c, f32(xf), f32(xb_T), Linv,
                              f32(mu), seed, noise=noise,
                              return_indices=return_indices)
