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

The draw: one uniform a (step, trajectory) from Philox4x32-10 keyed by
``seed``, counter (t, m, 0, ``TAG_FFBS``), mapped strictly inside (0, 1)
(:func:`uniforms_plain`), picks a column by inverse CDF over the
weights ``exp(w - max)`` summed in one fixed order: chunks of
:data:`CHUNK` columns, each lane of a warp summing its 32 columns left to
right, the lanes' totals by a Kogge-Stone scan, the chunks rescaled to
the row's max and summed left to right (:func:`lane_prefix`,
:func:`inverse_cdf_plain`; ``csrc/ffbs.cu`` spells the rule out).  The
twin repeats that arithmetic op for op, so kernel and twin compare draw
for draw.  It samples the categorical law the TPU kernel's Gumbel-max
draw samples (``use_prng``), with one uniform a draw and one ``exp`` a
column where Gumbel-max takes a random word and two logs a column.
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
CHUNK = 1024         # columns a chunk of the draw's summation order
LANES = 32           # a chunk's columns l + 32 i go to lane l
#: ``stats=`` slots: block 0's first warp's ``clock64`` cycles in the staging
#: (with the step's zb and uniform), the scores and max, the exp and
#: prefix sums, the search, the row, and the whole step loop
CLOCKS = ("stage", "score_max", "exp_sum", "search", "row", "loop")


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


def uniforms_plain(seed: int, t: int, M: int, device=None) -> torch.Tensor:
    """Kernel J's uniforms of step ``t``, [M] float32 in [2^-24, 1 - 2^-24]:
    Philox word 0 of counter (t, m, 0, ``TAG_FFBS``), ``((b >> 9) * 2 + 1)
    2^-24``, exact in float32."""
    k0, k1 = split_seed(seed)
    m = torch.arange(M, dtype=torch.int64, device=device)
    b = philox4x32_10(torch.full_like(m, int(t)), m, torch.zeros_like(m),
                      torch.full_like(m, TAG_FFBS), k0, k1)[0]
    return (((b >> 9) << 1) | 1).to(torch.float32) * _TWO_M24


def _ex(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``exp(a - b)`` as kernel J takes it: 0 where ``a`` is -inf or NaN,
    1 where ``a == b``."""
    e = torch.where(a == b, torch.ones_like(a), torch.exp(a - b))
    return torch.where(a > float("-inf"), e, torch.zeros_like(a))


def lane_prefix(e: torch.Tensor):
    """Kernel J's summation order over a chunk of weights ``e`` [..., R,
    32], column ``l + 32 i`` at ``[..., i, l]``: each lane's inclusive
    prefix ``Q`` over i, left to right; the lanes' exclusive prefix ``E``
    [..., 32] of their totals by a Kogge-Stone scan (add the value
    1, 2, 4, 8, 16 lanes down); and the chunk's total, the scan's last
    lane.  Returns ``(Q, E, total)``."""
    Q = torch.empty_like(e)
    acc = torch.zeros_like(e[..., 0, :])
    for i in range(e.shape[-2]):
        acc = acc + e[..., i, :]
        Q[..., i, :] = acc
    incl = acc
    for d in (1, 2, 4, 8, 16):
        incl = incl + torch.nn.functional.pad(incl[..., :-d], (d, 0))
    E = torch.nn.functional.pad(incl[..., :-1], (1, 0))
    return Q, E, incl[..., -1]


def _first(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last dim (0 where none)."""
    return torch.argmax(mask.to(torch.uint8), -1)


def _last(mask: torch.Tensor) -> torch.Tensor:
    """Index of the last True along the last dim (0 where none)."""
    n = mask.shape[-1]
    return n - 1 - _first(mask.flip(-1))


def inverse_cdf_plain(w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Kernel J's draw: the column [M] (int64) of the scores ``w`` [M, N]
    that the uniforms ``u`` [M] pick (the rule in ``csrc/ffbs.cu``): the
    chunks' maxes ``m_c`` and weights ``ex(w, m_c)`` summed by
    :func:`lane_prefix`; over the chunks ``mx``, ``f_c = ex(m_c, mx)``,
    ``a_c = s_c f_c`` and their running sum ``acc_c``, left to right;
    ``thr = u acc``; the first chunk with ``a_c > 0`` and ``acc_c + a_c >
    thr`` (else the last with ``a_c > 0``) and in it the first column,
    lanes first, of weight > 0 with ``acc_c + (E + Q) f_c > thr`` (else
    its last of weight > 0).  A row with no finite score takes column 0."""
    M, N = w.shape
    nC = -(-N // CHUNK)
    s = torch.where(torch.isnan(w), float("-inf"), w)
    s = torch.nn.functional.pad(s, (0, nC * CHUNK - N), value=float("-inf"))
    s = s.view(M, nC, CHUNK // LANES, LANES)
    mc = s.amax((-2, -1))                                  # [M, nC]
    e = _ex(s, mc[..., None, None])
    Q, E, sc = lane_prefix(e)
    mx = mc.amax(-1)                                       # [M]
    f = _ex(mc, mx[:, None])
    a = sc * f
    before = torch.empty_like(a)
    acc = torch.zeros_like(mx)
    for c in range(nC):
        before[:, c] = acc
        acc = acc + a[:, c]
    thr = u * acc
    hit = (a > 0) & (before + a > thr[:, None])
    cs = torch.where(hit.any(-1), _first(hit), _last(a > 0))
    rows = torch.arange(M, device=w.device)
    fc, ac = f[rows, cs], before[rows, cs]
    P = ac[:, None, None] + (E[rows, cs][:, None, :] + Q[rows, cs]) * \
        fc[:, None, None]
    nz = e[rows, cs] > 0                                   # [M, R, 32]
    hit = (nz & (P > thr[:, None, None])).transpose(1, 2).flatten(1)
    nz = nz.transpose(1, 2).flatten(1)                     # lanes first
    k = torch.where(hit.any(-1), _first(hit), _last(nz))
    R = CHUNK // LANES
    col = cs * CHUNK + (k % R) * LANES + k // R
    return torch.where(mx > float("-inf"), col, torch.zeros_like(col))


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
            i = inverse_cdf_plain(w, uniforms_plain(seed, t, M, dev))
        else:
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
                       noise: bool = True, return_indices: bool = False,
                       stats=None):
    """The backward pass on whitened inputs (:func:`whiten`): ``zpred``
    [T-1, N, nx], ``wfc`` [T-1, N], ``c`` [T-1, nx], ``xf`` [T-1, N, nx],
    ``xb_T`` [M, nx], ``Linv`` [nx, nx], ``mu`` [nx].  Returns ``xb``
    [T, M, nx] (and the chosen columns [T-1, M] int32 with
    ``return_indices``).  CUDA tensors launch kernel J; CPU tensors run
    the plain twin.  With ``stats`` (CUDA int64 [6]) the kernel writes
    block 0's first warp's ``clock64`` cycles by :data:`CLOCKS`."""
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
    if stats is not None and not (stats.is_cuda and stats.dtype == torch.int64
                                  and stats.numel() == len(CLOCKS)):
        raise ValueError(f"stats must be a CUDA int64 [{len(CLOCKS)}] tensor")
    if zpred.data_ptr() % 16:  # the chosen chunk's rows are vector loads
        zpred = zpred.clone()
    dev = zpred.device
    out = torch.empty(Tm1 + 1, M, nx, dtype=torch.float32, device=dev)
    idx = (torch.empty(Tm1, M, dtype=torch.int32, device=dev)
           if return_indices else None)
    chunks = (torch.empty(M, -(-N // CHUNK), 2, dtype=torch.float32,
                          device=dev) if N > CHUNK else None)
    check(library().lib.llpf_ffbs_backward(
        zpred.data_ptr(), wfc.data_ptr(), c.data_ptr(), xf.data_ptr(),
        xb_T.data_ptr(), Linv.data_ptr(), mu.data_ptr(), out.data_ptr(),
        idx.data_ptr() if idx is not None else None,
        chunks.data_ptr() if chunks is not None else None,
        stats.data_ptr() if stats is not None else None, Tm1, N, M, nx,
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
