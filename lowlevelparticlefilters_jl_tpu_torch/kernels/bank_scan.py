"""Shared-Riccati KF bank log-likelihood, kernel F (counterpart of
``ops/pallas/bank_scan.py``).

``filters/bank.py`` runs B datasets through one ``KalmanFilter`` with the
covariance recursion computed once.  What is left per member is the
mean recursion: per step t,

    Z  = Linv_t y − LD_t u − W2_tᵀ x,   ll −= ½‖Z‖²,
    x ← M_t x + AK_t y + BmAKD_t u,

with the per-step scalars built here from the shared recursion's
output.  They are computed in float64 and cast, so the result does not
depend on PyTorch's TF32 setting.  :func:`bank_loglik_scan` runs the
T-step loop: ``csrc/bank_scan.cu`` on CUDA tensors, the plain twin on
the CPU.

The recursion is affine with matrices shared by the bank, so a member's
time is split over the 32 lanes of a warp as a chunked linear scan.
Time runs in segments of 32 L steps (L odd, :func:`bank_plan`);
lane k owns the chunk of L steps k L .. k L + L − 1 of a segment.  Pass 1
runs each chunk from zero (lane 0 from the segment's start state) and
forms the chunk's composite Φ_k = M_end ⋯ M_start; a Kogge-Stone scan
over the lanes combines the pairs (Φ, δ) into every chunk's end state;
pass 2 reruns each chunk from its true start state and sums −½‖Z‖² in the
lane.  The end state of the last chunk starts the next segment, and at
the end the 32 lane sums are added in a tree (16, 8, 4, 2, 1).  The twin
:func:`bank_loglik_scan_plain` runs the same segments, chunks, scan and
tree on ``[B, 32]`` tensors, so the two differ only by the kernel's
contracted multiply-adds.
"""
from __future__ import annotations

import torch

from ..ops.linalg import tri_solve
from ._lib import KernelInfo, check, library, require_cuda_f32, stream_ptr

BANK_LOGLIK = KernelInfo(
    "bank_loglik", "lowlevelparticlefilters_jl_tpu_torch/csrc/bank_scan.cu",
    "lowlevelparticlefilters_jl_tpu/ops/pallas/bank_scan.py:200")

_LOG2PI = 1.8378770664093453
MAX_DIM = 4


def bank_kernel_supported(T: int, B: int, nx: int, ny: int, nu: int,
                          dtype) -> bool:
    """What kernel F can run (``method="kernel"`` honours exactly this):
    float32 and nx, ny, nu <= 4."""
    return (dtype == torch.float32 and 1 <= nx <= MAX_DIM
            and 1 <= ny <= MAX_DIM and 0 <= nu <= MAX_DIM)


def bank_kernel_profitable(T: int, B: int, nx: int, ny: int, nu: int,
                           dtype) -> bool:
    """The auto route's gate: supported, and at least 256 members (below
    that the plane path is already cheap)."""
    return B >= 256 and bank_kernel_supported(T, B, nx, ny, nu, dtype)


def bank_scalars(Schol, K, A, Bm, C, D, nu: int):
    """Per-step scalars ``[T, S]`` f32 (M | AK | Linv | W2 | BmAKD | LD,
    each block row-major) and the f64 constant Σ_t (log|det Linv_t| −
    ny/2 log 2π), from the shared recursion's [T, ...] stacks."""
    Schol, K, A, C = (t.double() for t in (Schol, K, A, C))
    T, ny = Schol.shape[0], Schol.shape[-1]
    nx = A.shape[-1]
    eye = torch.eye(ny, dtype=torch.float64, device=Schol.device)
    Linv = tri_solve(Schol, eye.expand(T, ny, ny), lower=True)
    AK = A @ K
    M = A - AK @ C
    W2 = C.mT @ Linv.mT
    cst = (-0.5 * ny * _LOG2PI * T
           + torch.log(torch.diagonal(Linv, dim1=-2, dim2=-1).abs()).sum())
    cols = [M.reshape(T, nx * nx), AK.reshape(T, nx * ny),
            Linv.reshape(T, ny * ny), W2.reshape(T, nx * ny)]
    if nu:
        Bm, D = Bm.double(), D.double()
        cols += [(Bm - AK @ D).reshape(T, nx * nu),
                 (Linv @ D).reshape(T, ny * nu)]
    return torch.cat(cols, 1).float().contiguous(), cst


def _offsets(nx: int, ny: int, nu: int):
    oAK = nx * nx
    oLi = oAK + nx * ny
    oW2 = oLi + ny * ny
    oBD = oW2 + nx * ny
    return oAK, oLi, oW2, oBD, oBD + nx * nu


LANES = 32
#: the largest chunk a lane runs (odd), by the padded width of the
#: kernel's step block (4 when nx or ny exceeds 2, else 2).  It does not
#: depend on the bank's size, so a member's ll is the same, bit for bit,
#: in any bank
MAX_LANE_STEPS = {2: 7, 4: 3}
#: ``stats=`` slots: block 0's first warp's ``clock64`` cycles in issuing
#: the copies, waiting for a segment (the copies and the block barrier),
#: pass 1, the scan, pass 2, and the whole kernel
CLOCKS = ("stage", "wait", "pass1", "scan", "pass2", "total")
#: shared memory a block may take (of the card's 227 KB)
SMEM_BUDGET = 227 * 1024
#: floats a staged row holds beyond its steps (``csrc/bank_scan.cu``
#: ``kSlack``: its head and the rest of its last 16-byte piece)
_SLACK = 8


def _widths(nx: int, ny: int, nu: int):
    """The kernel's padded widths: K for the state and the output (2 or
    4), KU for the input (0, 1, 2 or 4)."""
    return (2 if max(nx, ny) <= 2 else 4), (nu if nu <= 2 else 4)


def bank_plan(T: int, nx: int, ny: int, nu: int) -> int:
    """Steps a lane runs in a segment, L: the least odd L with 32 L >= T,
    at most ``MAX_LANE_STEPS``.  Odd, so that 32 lanes at steps k L + j
    of a segment laid out step after step read 32 different banks.  The
    kernel and the twin take the same L, so they cut time the same way."""
    cap = MAX_LANE_STEPS[_widths(nx, ny, nu)[0]]
    L = 1
    while L < cap and LANES * L < T:
        L += 2
    return L


def bank_smem_bytes(L: int, W: int, nx: int, ny: int, nu: int,
                    shared_u: bool, members: int = 1) -> int:
    """Dynamic shared memory of a block of W warps at L steps a lane:
    two stages of a segment's scalars (and of a shared input) and
    of each warp's rows for its ``members`` members, step after step, a
    step's scalars at an odd number of 16-byte vectors, each row with
    its slack (``csrc/bank_scan.cu`` ``Layout``)."""
    K, KU = _widths(nx, ny, nu)
    SP = 4 * K * K + 2 * K * KU
    Ss = SP if (SP // 4) % 2 else SP + 4
    n = LANES * L
    rows_y, rows_u = n * K + _SLACK, (n * KU + _SLACK if KU else 0)
    block = n * Ss + (rows_u if shared_u else 0)
    warp = members * (rows_y + (0 if shared_u else rows_u))
    return 2 * (block + W * warp) * 4


def bank_launch(B: int, T: int, nx: int, ny: int, nu: int, shared_u: bool,
                lane_steps: int | None = None):
    """The kernel's launch shape ``(L, W, members)``: L from
    :func:`bank_plan` (or ``lane_steps``); two members a warp (sharing
    each step's scalar loads and the chunk composites) when nx, ny <= 2
    and the bank has 4096 members or more; W warps a block, as many as a
    block's shared memory holds up to 16 (a block stages the scalars once
    for its members), 4 for smaller banks so that blocks reach every SM.
    Only L changes the arithmetic."""
    L = lane_steps or bank_plan(T, nx, ny, nu)
    narrow = _widths(nx, ny, nu)[0] == 2
    mb = 2 if narrow and B >= 4096 else 1
    W = 16 if B >= 4096 else 4
    while W > 1 and bank_smem_bytes(L, W, nx, ny, nu, shared_u,
                                    mb) > SMEM_BUDGET:
        W //= 2
    return L, W, mb


def _combine_rows(P, v, base=None):
    """Σ_q P[i][q] v[q] (+ base[i]) for each i, the products summed in q
    order: the kernel's order of a matrix-vector product."""
    out = []
    for i in range(len(P)):
        a = P[i][0] * v[0]
        for q in range(1, len(v)):
            a = a + P[i][q] * v[q]
        out.append(a if base is None else a + base[i])
    return out


def _drive(s, Y, U, X, nx, ny, nu, o):
    """x ← AK y + BmAKD u + M x, in the kernel's order (the drive first,
    then M x, each sum in index order)."""
    oAK, _, _, oBD, _ = o
    Xn = []
    for i in range(nx):
        a = s[oAK + i * ny] * Y[0]
        for j in range(1, ny):
            a = a + s[oAK + i * ny + j] * Y[j]
        for j in range(nu):
            a = a + s[oBD + i * nu + j] * U[j]
        for j in range(nx):
            a = a + s[i * nx + j] * X[j]
        Xn.append(a)
    return Xn


def bank_loglik_scan_plain(scal, ys, us, x0, nx: int, ny: int, nu: int,
                           _lane_steps: int | None = None):
    """The kernel's chunked scan on ``[B, 32]`` tensors (lane k of every
    member in column k), in its order of operations: segments of 32 L
    steps, pass 1 from zero, the Kogge-Stone scan of the chunks' pairs,
    pass 2 from the chunks' true start states, the lanes' tree.
    ``_lane_steps`` forces L (tests reach several segments with it)."""
    o = _offsets(nx, ny, nu)
    _, oLi, oW2, _, oLD = o
    Bk, T = ys.shape[0], ys.shape[1]
    L = _lane_steps or bank_plan(T, nx, ny, nu)
    dev, dt = ys.device, ys.dtype
    lanes = torch.arange(LANES, device=dev)
    xin = [x0[i].to(dt).expand(Bk) for i in range(nx)]
    acc = ys.new_zeros(Bk, LANES)
    eye = [[torch.full((LANES,), float(i == j), dtype=dt, device=dev)
            for j in range(nx)] for i in range(nx)]

    def step_inputs(g0, n, j):
        live = lanes * L + j < n                       # [32]
        t = (g0 + lanes * L + j).clamp(max=T - 1)
        s = scal[t].to(dt).T                           # [S, 32]
        Y = [ys[:, t, c] for c in range(ny)]           # [B, 32] each
        U = [us[:, t, c] for c in range(nu)]
        return live, s, Y, U

    for g0 in range(0, T, LANES * L):
        n = min(LANES * L, T - g0)
        nch = -(-n // L)
        steps = min(L, n)
        # pass 1: each chunk from zero, chunk 0 from the segment's start
        D = [torch.cat([xin[i][:, None], ys.new_zeros(Bk, LANES - 1)], 1)
             for i in range(nx)]
        Phi = [row[:] for row in eye]
        for j in range(steps):
            live, s, Y, U = step_inputs(g0, n, j)
            Dn = _drive(s, Y, U, D, nx, ny, nu, o)
            D = [torch.where(live, a, b) for a, b in zip(Dn, D)]
            M = [[s[i * nx + q] for q in range(nx)] for i in range(nx)]
            Pn = [_combine_rows(M, [Phi[q][c] for q in range(nx)])
                  for c in range(nx)]
            Phi = [[torch.where(live, Pn[c][i], Phi[i][c])
                    for c in range(nx)] for i in range(nx)]
        # Kogge-Stone over the chunk ends: after level d, lane k holds the
        # state at the end of its chunk from chunks k - 2^{d+1} + 1 .. k
        d = 0
        while (1 << d) < nch:
            sh = 1 << d
            Dp = [torch.cat([v[:, :1].expand(Bk, sh), v[:, :-sh]], 1)
                  for v in D]
            Pp = [[torch.cat([v[:1].expand(sh), v[:-sh]]) for v in row]
                  for row in Phi]
            hi = lanes >= sh
            Dn = _combine_rows(Phi, Dp, D)
            D = [torch.where(hi, a, b) for a, b in zip(Dn, D)]
            Pn = [_combine_rows(Phi, [Pp[q][c] for q in range(nx)])
                  for c in range(nx)]
            Phi = [[torch.where(hi, Pn[c][i], Phi[i][c])
                    for c in range(nx)] for i in range(nx)]
            d += 1
        # pass 2: each chunk from its true start state
        X = [torch.cat([xin[i][:, None], D[i][:, :-1]], 1) for i in range(nx)]
        xin = [v[:, nch - 1] for v in D]
        for j in range(steps):
            live, s, Y, U = step_inputs(g0, n, j)
            dll = ys.new_zeros(Bk, LANES)
            for z in range(ny):
                a = s[oLi + z * ny] * Y[0]
                for j2 in range(1, ny):
                    a = a + s[oLi + z * ny + j2] * Y[j2]
                for j2 in range(nu):
                    a = a - s[oLD + z * nu + j2] * U[j2]
                for i in range(nx):
                    a = a - s[oW2 + i * ny + z] * X[i]
                dll = dll - 0.5 * a * a
            acc = torch.where(live, acc + dll, acc)
            Xn = _drive(s, Y, U, X, nx, ny, nu, o)
            X = [torch.where(live, a, b) for a, b in zip(Xn, X)]
    h = LANES // 2
    while h:
        acc = acc[:, :h] + acc[:, h:2 * h]
        h //= 2
    return acc[:, 0]


def _aligned(t):
    """``t``, or a copy of it where its data does not start on 16 bytes
    (the kernel copies and reads rows in 16- and 8-byte pieces)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def bank_loglik_scan(scal, ys, us, x0, nx: int, ny: int, nu: int,
                     stats=None, _lane_steps: int | None = None):
    """Σ_t −½‖Z_t‖² per member ``[B]`` (without the constant):
    ``scal [T, S]``, ``ys [B, T, ny]``, ``us [B, T, nu]`` (a shared input
    may have member stride 0), ``x0 [nx]``.  The launch shape is
    :func:`bank_launch`'s; a member's result does not depend on the
    bank's size.  With ``stats`` (CUDA int64 [6]; nx, ny <= 2, nu = 1;
    the kernel then runs one member a warp) the kernel writes block 0's
    first warp's ``clock64`` cycles by :data:`CLOCKS`.  ``_lane_steps``
    forces L on both routes (tests)."""
    if not ys.is_cuda:
        return bank_loglik_scan_plain(scal, ys, us, x0, nx, ny, nu,
                                      _lane_steps)
    Bk, T, _ = ys.shape
    if not bank_kernel_supported(T, Bk, nx, ny, nu, ys.dtype):
        raise ValueError("bank_loglik: needs float32 and nx, ny, nu <= 4")
    S = scal.shape[1]
    require_cuda_f32("scalars", scal, (T, S))
    require_cuda_f32("ys", ys, (Bk, T, ny))
    require_cuda_f32("x0", x0, (nx,))
    ys = _aligned(ys)
    us_ptr, us_b = 0, 0
    if nu:
        if us.stride(0) == 0:
            us = us[0].contiguous()
            require_cuda_f32("us", us, (T, nu))
        else:
            us = us.contiguous()
            require_cuda_f32("us", us, (Bk, T, nu))
            us_b = T * nu
        us = _aligned(us)
        us_ptr = us.data_ptr()
    L, W, mb = bank_launch(Bk, T, nx, ny, nu, nu > 0 and us_b == 0,
                           _lane_steps)
    ll = torch.empty(Bk, dtype=torch.float32, device=ys.device)
    if stats is not None:
        if not (stats.is_cuda and stats.dtype == torch.int64
                and stats.numel() == len(CLOCKS)):
            raise ValueError(
                f"stats must be a CUDA int64 [{len(CLOCKS)}] tensor")
        mb = 1
    check(library().lib.llpf_bank_loglik(
        scal.data_ptr(), S, ys.data_ptr(), us_ptr, us_b, x0.data_ptr(),
        ll.data_ptr(), Bk, T, nx, ny, nu, L, W, mb,
        stats.data_ptr() if stats is not None else None, stream_ptr(ys)),
        "bank_loglik")
    BANK_LOGLIK.launches += 1
    return ll


def bank_loglik_kernel(kf, us, ys, Schol, K, A, Bm, C, D):
    """Bank log-likelihood ``[B]`` through kernel F (its plain twin on CPU
    tensors).  Inputs follow ``filters/bank.py::_bank_scan``: ``ys [B, T,
    ny]``, ``us [B, T, nu]`` and the shared recursion's [T, ...] stacks."""
    nu = us.shape[-1]
    scal, cst = bank_scalars(Schol, K, A, Bm, C, D, nu)
    x0 = kf.d0.mean.to(dtype=torch.float32, device=ys.device).contiguous()
    ll = bank_loglik_scan(scal, ys.float(), us.float(), x0, kf.nx,
                          ys.shape[-1], nu)
    return ll + cst.float()
