"""Temporal parallelization of Kalman filtering and RTS smoothing
(counterpart of ``parallel/temporal.py``).

The linear-Gaussian recursion is associative (Särkkä & García-Fernández,
"Temporal Parallelization of Bayesian Smoothers", arXiv:1905.13002):
filtering and smoothing factor into per-step elements combined by an
associative operator, so an inclusive prefix scan gives every filtered
(or smoothed) moment in O(log T) depth.

Filtering element k: (A, b, C, η, J); combination (earlier ⊗ later):
    D = (I + C1 J2)⁻¹
    A = A2 D A1,          b = A2 D (b1 + C1 η2) + b2,  C = A2 D C1 A2ᵀ + C2
    η = A1ᵀ Dᵀ (η2 − J2 b1) + η1,   J = A1ᵀ Dᵀ J2 A1 + J1
After the scan, b_k / C_k are the filtered mean and covariance.

Smoothing element k: (E, g, L), combined in reverse:
    (E_i, g_i, L_i) ∘ (E_j, g_j, L_j) = (E_i E_j, E_i g_j + g_i,
                                         E_i L_j E_iᵀ + L_i)
giving the smoothed mean and covariance g_k / L_k.

Up to ``_PLANE_N`` = 8 states the pipeline runs on "planes": a matrix is
a tuple of tuples of [T] tensors, one per entry, and every formula is
elementwise arithmetic, as in the JAX package.  The planes are no TPU
tiling device here, just [T] tensors; on CUDA f32 the scans go to kernel
K (kernels/assoc_scan.py), which lays the elements out as it likes.
Wider states take batched [T, n, n] arrays.  ``jax.lax.associative_scan``
becomes :func:`associative_scan`, a Hillis–Steele scan.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..ops.linalg import chol_lower, rdiv_chol, solve_nopivot, symmetrize
from ..ops.matrices import (FnMat, IndexingMatrix, TimeVarying,
                            TransposedIndexingMatrix, resolve_mat)
from ..ops.mvnormal import mvnormal_logpdf
from ..utils.solutions import KalmanFilteringSolution, KalmanSmoothingSolution


def _leaves(tree) -> list:
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _rebuild(tree, it):
    if isinstance(tree, (tuple, list)):
        return tuple(_rebuild(t, it) for t in tree)
    return next(it)


def associative_scan(fn, elems, reverse: bool = False):
    """Inclusive scan of the nested tuple of tensors ``elems`` along
    axis 0 under the associative ``fn(earlier, later)``: log₂T levels, at
    level s entry k becomes ``fn(x[k - s], x[k])`` for k >= s.  With
    ``reverse`` the scan runs from the end (``fn`` still takes the prefix
    so far first), as ``jax.lax.associative_scan(..., reverse=True)``."""
    leaves = _leaves(elems)
    if reverse:
        leaves = [x.flip(0) for x in leaves]
    T = leaves[0].shape[0]
    s = 1
    while s < T:
        left = _rebuild(elems, iter([x[:-s] for x in leaves]))
        right = _rebuild(elems, iter([x[s:] for x in leaves]))
        comb = _leaves(fn(left, right))
        leaves = [torch.cat([x[:s], c]) for x, c in zip(leaves, comb)]
        s *= 2
    if reverse:
        leaves = [x.flip(0) for x in leaves]
    return _rebuild(elems, iter(leaves))


def _resolve_seq(M, T: int, x0=None, u_seq=None, tvec=None, p=None,
                 Ts: float = 1.0) -> Optional[torch.Tensor]:
    """A matrix spec as a [T, ...] stack: a constant is expanded, a
    time-stacked tensor (or :class:`TimeVarying`) gives its first T
    steps, as ``resolve_mat`` indexes it at step k; an indexing matrix is
    densified (in ``x0``'s dtype and device); a callable is evaluated at
    ``x0`` and each step's input ``u_seq[k]`` and time ``tvec[k]`` in one
    ``vmap``, which is right only for a matrix that does not depend on
    the state (:func:`_state_indep_flag` checks)."""
    if M is None:
        return None
    if isinstance(M, (IndexingMatrix, TransposedIndexingMatrix)):
        like = x0 if x0 is not None else torch.zeros(())
        D = M.todense(like.dtype, like.device)
        return D.expand(T, *D.shape)
    if isinstance(M, FnMat):
        out = torch.func.vmap(lambda uk, tk: resolve_mat(M, x0, uk, p, tk,
                                                         Ts=Ts))(u_seq, tvec)
        return out.expand(T, *out.shape[-2:]) if out.ndim == 2 else out
    data = M.data if isinstance(M, TimeVarying) else M
    if data.ndim == 2:
        return data.expand(T, *data.shape)
    if data.shape[0] < T:
        raise ValueError(f"a time-stacked matrix has {data.shape[0]} steps, "
                         f"the data {T}")
    return data[:T]


def _state_indep_flag(M, x0, u0, p, t0, Ts: float = 1.0):
    """The temporal-parallel path's guard for a callable matrix, which
    :func:`_resolve_seq` evaluates at ``x0`` for every step: None for any
    other spec, else a 0-dim bool tensor that is False when the matrix
    changes with the state.  Two fixed directions are probed (a single
    shift would pass a matrix periodic or flat along it); inputs are not
    probed, since each step resolves the matrix at its own input.  The
    solution verbs AND it into ``sol.ok``."""
    if not isinstance(M, FnMat):
        return None
    a = resolve_mat(M, x0, u0, p, t0, Ts=Ts)
    k = torch.arange(x0.shape[-1], dtype=x0.dtype, device=x0.device)
    d1 = torch.cos(1.0 + 2.399963 * k)
    d2 = torch.sin(0.5 + 1.618034 * k)
    ok = torch.ones((), dtype=torch.bool, device=a.device)
    for dx in (1.7 * d1, -0.9 * d2):
        b = resolve_mat(M, x0 + dx, u0, p, t0, Ts=Ts)
        ok = ok & ((a - b).abs() <= 1e-6 * (1.0 + a.abs())).all()
    return ok


def _callback_affine_in_x(fn, nx: int, u0, p, t0) -> bool:
    """Static check that ``fn(x, u, p, t)`` is affine in x for every u and
    t: the callback lowered at ``(0, u0, t0)`` (in ``u0``'s dtype and
    device) and walked
    (``kernels/ukf_scan.callback_affine_in_x``).  Fails closed on anything
    the walk cannot prove affine."""
    from ..kernels.ukf_scan import callback_affine_in_x

    u0 = torch.as_tensor(u0)
    x0 = torch.zeros(nx, dtype=u0.dtype, device=u0.device)
    t0 = torch.as_tensor(t0, dtype=u0.dtype, device=u0.device)
    return callback_affine_in_x(fn, x0, u0, p, t0) is not None


def _mv_t(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[T, n, m] @ [T, m] -> [T, n] as an elementwise sum (no TF32)."""
    return (M * v[..., None, :]).sum(-1)


# ---------------------------------------------------------------------------
# Batched [T, n, n] elements (wide states)
# ---------------------------------------------------------------------------


def _filter_elements(F, c, H, Q, R, y, m0, P0):
    """Per-step filtering elements (§III-B of the paper) in the
    correct-then-predict convention: element 0 updates the prior, and the
    transition entering step k is the one of step k−1."""
    T, nx = c.shape
    eye = torch.eye(nx, dtype=c.dtype, device=c.device)
    Fk, ck, Hk, Qk, Rk, yk = F[:-1], c[:-1], H[1:], Q[:-1], R[1:], y[1:]
    S = symmetrize(Hk @ Qk @ Hk.mT) + Rk
    Sch = chol_lower(S)
    K = rdiv_chol(Qk @ Hk.mT, Sch)
    ImKH = eye - K @ Hk
    resid = yk - _mv_t(Hk, ck)
    A = ImKH @ Fk
    b = ck + _mv_t(K, resid)
    C = symmetrize(ImKH @ Qk)
    HtSinv = rdiv_chol(Hk.mT, Sch)
    eta = _mv_t(Fk.mT @ HtSinv, resid)
    J = symmetrize(Fk.mT @ HtSinv @ Hk @ Fk)

    S0 = symmetrize(H[0] @ P0 @ H[0].T) + R[0]
    K0 = rdiv_chol(P0 @ H[0].T, chol_lower(S0))
    b0 = m0 + K0 @ (y[0] - H[0] @ m0)
    C0 = symmetrize((eye - K0 @ H[0]) @ P0)
    zm = torch.zeros((1, nx, nx), dtype=c.dtype, device=c.device)
    return (torch.cat([zm, A]), torch.cat([b0[None], b]),
            torch.cat([C0[None], C]),
            torch.cat([torch.zeros_like(b0)[None], eta]), torch.cat([zm, J]))


def _filter_combine(e1, e2):
    A1, b1, C1, eta1, J1 = e1
    A2, b2, C2, eta2, J2 = e2
    eye = torch.eye(A1.shape[-1], dtype=A1.dtype, device=A1.device)
    # M = I + C1 J2 with C1, J2 PSD has every eigenvalue >= 1, so the
    # no-pivot solve is safe
    M = eye + C1 @ J2
    A2_D = solve_nopivot(M.mT, A2.mT).mT          # A2 D
    G = solve_nopivot(M, A1)                      # Gᵀ = A1ᵀ Dᵀ
    A = A2_D @ A1
    b = _mv_t(A2_D, b1 + _mv_t(C1, eta2)) + b2
    C = A2_D @ C1 @ A2.mT + C2
    eta = _mv_t(G.mT, eta2 - _mv_t(J2, b1)) + eta1
    J = G.mT @ (J2 @ A1) + J1
    return A, b, symmetrize(C), eta, symmetrize(J)


def _smooth_elements(F, c, Q, xt, Rt):
    """Per-step smoothing elements (§IV of the paper); element k uses the
    step-k transition, and the last is the identity at the filtered
    terminal state."""
    Fk, ck, Qk, mk, Pk = F[:-1], c[:-1], Q[:-1], xt[:-1], Rt[:-1]
    Pp = symmetrize(Fk @ Pk @ Fk.mT) + Qk
    E = rdiv_chol(Pk @ Fk.mT, chol_lower(Pp))
    g = mk - _mv_t(E, _mv_t(Fk, mk) + ck)
    L = symmetrize(Pk - E @ Fk @ Pk)
    return (torch.cat([E, torch.zeros_like(Rt[-1:])]),
            torch.cat([g, xt[-1:]]), torch.cat([L, Rt[-1:]]))


def _smooth_combine(ei, ej):
    """Reverse-direction combination: element i (earlier) absorbs j."""
    E1, g1, L1 = ei
    E2, g2, L2 = ej
    return (E1 @ E2, _mv_t(E1, g2) + g1,
            symmetrize(E1 @ L2 @ E1.mT + L1))


# ---------------------------------------------------------------------------
# Plane algebra: a matrix is a tuple of tuples of [T] tensors
# ---------------------------------------------------------------------------


def _m_split(M):
    """[T, n, m] tensor -> tuple-of-tuples of [T] planes."""
    return tuple(tuple(M[:, i, j] for j in range(M.shape[2]))
                 for i in range(M.shape[1]))


def _m_join(Mt) -> torch.Tensor:
    """tuple-of-tuples of [T] planes -> [T, n, m] tensor."""
    return torch.stack([torch.stack(list(r), -1) for r in Mt], -2)


def _v_split(v):
    return tuple(v[:, i] for i in range(v.shape[1]))


def _v_join(v) -> torch.Tensor:
    return torch.stack(list(v), -1)


def _mm_p(A, B):
    k, m = len(B), len(B[0])
    return tuple(tuple(sum(A[i][q] * B[q][j] for q in range(k))
                       for j in range(m)) for i in range(len(A)))


def _mv_p(A, b):
    return tuple(sum(A[i][q] * b[q] for q in range(len(b)))
                 for i in range(len(A)))


def _mt_p(A):
    return tuple(tuple(A[i][j] for i in range(len(A)))
                 for j in range(len(A[0])))


def _madd_p(A, B):
    return tuple(tuple(a + b for a, b in zip(ra, rb))
                 for ra, rb in zip(A, B))


def _msub_p(A, B):
    return tuple(tuple(a - b for a, b in zip(ra, rb))
                 for ra, rb in zip(A, B))


def _vadd_p(a, b):
    return tuple(x + y for x, y in zip(a, b))


def _vsub_p(a, b):
    return tuple(x - y for x, y in zip(a, b))


def _sym_p(A):
    return tuple(tuple(0.5 * (A[i][j] + A[j][i]) for j in range(len(A)))
                 for i in range(len(A)))


def _solve_nopivot_p(M, B):
    """No-pivot Gaussian elimination on planes (the pivot-safety contract
    of :func:`...ops.linalg.solve_nopivot`: here M = I + C J)."""
    n, m = len(M), len(B[0])
    Mr = [list(r) for r in M]
    Br = [list(r) for r in B]
    for k in range(n):
        piv = Mr[k][k]
        for i in range(k + 1, n):
            f = Mr[i][k] / piv
            for j in range(k + 1, n):
                Mr[i][j] = Mr[i][j] - f * Mr[k][j]
            for j in range(m):
                Br[i][j] = Br[i][j] - f * Br[k][j]
    X = [[None] * m for _ in range(n)]
    for i in range(n - 1, -1, -1):
        for j in range(m):
            acc = Br[i][j]
            for q in range(i + 1, n):
                acc = acc - Mr[i][q] * X[q][j]
            X[i][j] = acc / Mr[i][i]
    return tuple(tuple(r) for r in X)


def _chol_p(S):
    """Unrolled Cholesky–Banachiewicz on planes (zeros above the
    diagonal)."""
    n = len(S)
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = S[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = torch.sqrt(s) if i == j else s / L[j][j]
    zero = torch.zeros_like(S[0][0])
    return tuple(tuple(L[i][j] if j <= i else zero for j in range(n))
                 for i in range(n))


def _trisolve_lower_p(L, B):
    """Forward substitution L Z = B on planes."""
    n, m = len(L), len(B[0])
    Z = [[None] * m for _ in range(n)]
    for i in range(n):
        for j in range(m):
            s = B[i][j]
            for k in range(i):
                s = s - L[i][k] * Z[k][j]
            Z[i][j] = s / L[i][i]
    return tuple(tuple(r) for r in Z)


def _chol_solve_p(L, B):
    """(L Lᵀ)⁻¹ B on planes."""
    n, m = len(L), len(B[0])
    Z = _trisolve_lower_p(L, B)
    X = [[None] * m for _ in range(n)]
    for i in range(n - 1, -1, -1):
        for j in range(m):
            s = Z[i][j]
            for k in range(i + 1, n):
                s = s - L[k][i] * X[k][j]
            X[i][j] = s / L[i][i]
    return tuple(tuple(r) for r in X)


def _rdiv_chol_p(B, L):
    """B (L Lᵀ)⁻¹ on planes."""
    return _mt_p(_chol_solve_p(L, _mt_p(B)))


def _filter_combine_soa(e1, e2):
    """Plane form of :func:`_filter_combine` (the same formulas)."""
    A1, b1, C1, eta1, J1 = e1
    A2, b2, C2, eta2, J2 = e2
    n = len(A1)
    CJ = _mm_p(C1, J2)
    M = tuple(tuple(CJ[i][j] + (1.0 if i == j else 0.0) for j in range(n))
              for i in range(n))
    A2_D = _mt_p(_solve_nopivot_p(_mt_p(M), _mt_p(A2)))   # A2 D
    G = _solve_nopivot_p(M, A1)                           # D A1
    A = _mm_p(A2_D, A1)
    b = _vadd_p(_mv_p(A2_D, _vadd_p(b1, _mv_p(C1, eta2))), b2)
    C = _sym_p(_madd_p(_mm_p(_mm_p(A2_D, C1), _mt_p(A2)), C2))
    eta = _vadd_p(_mv_p(_mt_p(G), _vsub_p(eta2, _mv_p(J2, b1))), eta1)
    J = _sym_p(_madd_p(_mm_p(_mt_p(G), _mm_p(J2, A1)), J1))
    return A, b, C, eta, J


def _smooth_combine_soa(ei, ej):
    """Plane form of :func:`_smooth_combine`."""
    E1, g1, L1 = ei
    E2, g2, L2 = ej
    E = _mm_p(E1, E2)
    g = _vadd_p(_mv_p(E1, g2), g1)
    L = _sym_p(_madd_p(_mm_p(_mm_p(E1, L2), _mt_p(E1)), L1))
    return E, g, L


def _shift1(x):
    """[T] plane of step-k values -> plane of step k−1 values (0 at k = 0,
    where the step-0 mask overrides the element)."""
    return torch.cat([x.new_zeros(1), x[:-1]])


def _shift_m(M):
    return tuple(tuple(_shift1(e) for e in r) for r in M)


def _shift_v(v):
    return tuple(_shift1(e) for e in v)


def _where_m(mask, val2d, M):
    """Per-plane select of ``val2d`` (a scalar or an [n, m] tensor) at the
    masked steps."""
    def getv(i, j):
        return val2d if isinstance(val2d, float) else val2d[i, j]
    return tuple(tuple(torch.where(mask, getv(i, j), M[i][j])
                       for j in range(len(M[0]))) for i in range(len(M)))


def _where_v(mask, val1d, v):
    def getv(i):
        return val1d if isinstance(val1d, float) else val1d[i]
    return tuple(torch.where(mask, getv(i), e) for i, e in enumerate(v))


def _filter_elements_p(Fp, cp, Hp, Qp, Rp, yp, m0, P0, T):
    """Plane form of :func:`_filter_elements`.  The step-0 values from
    the zero-filled k−1 shifts (finite, since S = R there) are replaced by
    the prior-update element."""
    nx = len(cp)
    Fm, cm, Qm = _shift_m(Fp), _shift_v(cp), _shift_m(Qp)
    S = _sym_p(_madd_p(_mm_p(_mm_p(Hp, Qm), _mt_p(Hp)), Rp))
    Sch = _chol_p(S)
    K = _rdiv_chol_p(_mm_p(Qm, _mt_p(Hp)), Sch)
    KH = _mm_p(K, Hp)
    ImKH = tuple(tuple((1.0 if i == j else 0.0) - KH[i][j]
                       for j in range(nx)) for i in range(nx))
    resid = _vsub_p(yp, _mv_p(Hp, cm))
    A = _mm_p(ImKH, Fm)
    b = _vadd_p(cm, _mv_p(K, resid))
    C = _sym_p(_mm_p(ImKH, Qm))
    HtSinv = _rdiv_chol_p(_mt_p(Hp), Sch)
    FtHtSinv = _mm_p(_mt_p(Fm), HtSinv)
    eta = _mv_p(FtHtSinv, resid)
    J = _sym_p(_mm_p(FtHtSinv, _mm_p(Hp, Fm)))

    # element 0: measurement update of the prior
    H0 = torch.stack([torch.stack([e[0] for e in r]) for r in Hp])
    R0 = torch.stack([torch.stack([e[0] for e in r]) for r in Rp])
    y0 = torch.stack([e[0] for e in yp])
    eye = torch.eye(nx, dtype=y0.dtype, device=y0.device)
    S0 = symmetrize(H0 @ P0 @ H0.T) + R0
    K0 = rdiv_chol(P0 @ H0.T, chol_lower(S0))
    b0 = m0 + K0 @ (y0 - H0 @ m0)
    C0 = symmetrize((eye - K0 @ H0) @ P0)

    m = torch.arange(T, device=y0.device) == 0
    return (_where_m(m, 0.0, A), _where_v(m, b0, b), _where_m(m, C0, C),
            _where_v(m, 0.0, eta), _where_m(m, 0.0, J))


def _smooth_elements_p(Fp, cp, Qp, xtp, Ctp, T):
    """Plane form of :func:`_smooth_elements`."""
    Pp = _sym_p(_madd_p(_mm_p(_mm_p(Fp, Ctp), _mt_p(Fp)), Qp))
    Pch = _chol_p(Pp)
    E = _rdiv_chol_p(_mm_p(Ctp, _mt_p(Fp)), Pch)
    g = _vsub_p(xtp, _mv_p(E, _vadd_p(_mv_p(Fp, xtp), cp)))
    L = _sym_p(_msub_p(Ctp, _mm_p(_mm_p(E, Fp), Ctp)))
    m = torch.arange(T, device=xtp[0].device) == T - 1
    E = _where_m(m, 0.0, E)
    g = tuple(torch.where(m, xi, gi) for xi, gi in zip(xtp, g))
    L = tuple(tuple(torch.where(m, Ctp[i][j], L[i][j])
                    for j in range(len(L[0]))) for i in range(len(L)))
    return E, g, L


def _kernel_takes(nx: int, elems) -> bool:
    """Kernel K takes a scan of ``elems`` (any nesting of tensors): CUDA
    f32 with nx <= 8 (``assoc_scan.scan_supported``) and no tensor that
    autograd records (``routing._needs_grad``): the kernel is
    forward-only, the twin differentiable."""
    from ..kernels.assoc_scan import scan_supported
    from ..routing import _needs_grad

    return (scan_supported(nx, _leaves(elems)[0])
            and not _needs_grad(elems))


def _scan_filter_p(elems_p):
    """Inclusive filter-combine scan of plane elements: kernel K where
    :func:`_kernel_takes`, its Hillis–Steele twin elsewhere.  Returns
    (xt planes, Rt planes)."""
    from ..kernels import assoc_scan as k

    if _kernel_takes(len(elems_p[1]), elems_p):
        return k.filter_scan_p(elems_p)
    return k.filter_scan_p_plain(elems_p)


def _scan_smooth_p(elems_p):
    """The reverse smooth-combine scan: (xT planes, RT planes)."""
    from ..kernels import assoc_scan as k

    if _kernel_takes(len(elems_p[1]), elems_p):
        return k.smooth_scan_p(elems_p)
    return k.smooth_scan_p_plain(elems_p)


def scan_route(nx: int, ny: int, like: torch.Tensor) -> str:
    """The route name of a temporal-parallel pass whose output is
    ``like``: ``"cuda_temporal_parallel"`` when kernel K takes the scans
    (:func:`_kernel_takes`), ``"temporal_parallel_plain"`` otherwise."""
    planes = nx <= _PLANE_N and ny <= _PLANE_N
    return ("cuda_temporal_parallel" if planes and _kernel_takes(nx, like)
            else "temporal_parallel_plain")


def _parallel_filter_core_p(F, c, H, Q, R, y_eff, m0, P0):
    """Plane-pipeline filter on stacked [T, ...] tensors (split once
    here); see :func:`_parallel_filter_core_pp`."""
    return _parallel_filter_core_pp(
        _m_split(F), _v_split(c), _m_split(H), _m_split(Q), _m_split(R),
        _v_split(y_eff), m0, P0, y_eff.shape[0])


def _filtered_moments_pp(Fp, cp, Hp, Qp, Rp, yp, m0, P0, T):
    """The filtered means and covariances (xt planes, Rt planes) alone:
    the elements and the scan, without the post-hoc outputs."""
    return _scan_filter_p(_filter_elements_p(Fp, cp, Hp, Qp, Rp, yp, m0, P0,
                                             T))


def _parallel_filter_core_pp(Fp, cp, Hp, Qp, Rp, yp, m0, P0, T):
    """Plane-pipeline filter: returns ``(xp, Rp_pred, xtp, Ctp, ep, Sp,
    Schp, Kp, lls)``, all plane structures except the [T] tensor
    ``lls``."""
    ny = len(yp)
    xtp, Ctp = _filtered_moments_pp(Fp, cp, Hp, Qp, Rp, yp, m0, P0, T)

    # predicted moments, innovations and gains; x_pred[0] is the prior
    Fm, cm, Qm = _shift_m(Fp), _shift_v(cp), _shift_m(Qp)
    xp = _vadd_p(_mv_p(Fm, _shift_v(xtp)), cm)
    Rpred = _madd_p(_mm_p(_mm_p(Fm, _shift_m(Ctp)), _mt_p(Fm)), Qm)
    m = torch.arange(T, device=yp[0].device) == 0
    xp = _where_v(m, m0, xp)
    Rpred = _where_m(m, P0, Rpred)
    ep = _vsub_p(yp, _mv_p(Hp, xp))
    Sp = _sym_p(_madd_p(_mm_p(_mm_p(Hp, Rpred), _mt_p(Hp)), Rp))
    Schp = _chol_p(Sp)
    Kp = _rdiv_chol_p(_mm_p(Rpred, _mt_p(Hp)), Schp)
    z = _trisolve_lower_p(Schp, tuple((ei,) for ei in ep))
    quad = sum(z[i][0] * z[i][0] for i in range(ny))
    logdet = 2.0 * sum(torch.log(Schp[i][i]) for i in range(ny))
    lls = -0.5 * (ny * math.log(2.0 * math.pi) + logdet + quad)
    return xp, Rpred, xtp, Ctp, ep, Sp, Schp, Kp, lls


# plane pipelines unroll n³ scalar formulas; above this the batched
# array pipeline takes over
_PLANE_N = 8


def _parallel_filter_core(F, c, H, Q, R, y_eff, m0, P0):
    """Associative-scan filtering of a prepared affine model: stacked
    [T, ...] inputs, ``(x_pred, R_pred, xt, Rt, e, S, Schol, K, lls)``
    out as [T, ...] tensors."""
    if c.shape[-1] > _PLANE_N or y_eff.shape[-1] > _PLANE_N:
        return _parallel_filter_core_arrays(F, c, H, Q, R, y_eff, m0, P0)
    xp, Rpred, xtp, Ctp, ep, Sp, Schp, Kp, lls = _parallel_filter_core_p(
        F, c, H, Q, R, y_eff, m0, P0)
    return (_v_join(xp), _m_join(Rpred), _v_join(xtp), _m_join(Ctp),
            _v_join(ep), _m_join(Sp), _m_join(Schp), _m_join(Kp), lls)


def _parallel_filter_core_arrays(F, c, H, Q, R, y_eff, m0, P0):
    """The same pipeline on batched [T, n, n] tensors (wide states)."""
    A, b, C, eta, J = _filter_elements(F, c, H, Q, R, y_eff, m0, P0)
    _, xt, Rt, _, _ = associative_scan(_filter_combine, (A, b, C, eta, J))
    x_pred = torch.cat([m0[None], _mv_t(F[:-1], xt[:-1]) + c[:-1]])
    R_pred = torch.cat([P0[None], symmetrize(F[:-1] @ Rt[:-1] @ F[:-1].mT)
                        + Q[:-1]])
    e = y_eff - _mv_t(H, x_pred)
    S = symmetrize(H @ R_pred @ H.mT) + R
    Schol = chol_lower(S)
    K = rdiv_chol(R_pred @ H.mT, Schol)
    lls = mvnormal_logpdf(e, torch.zeros_like(e), Schol)
    return x_pred, R_pred, xt, Rt, e, S, Schol, K, lls


def _parallel_smooth_core(F, c, Q, xt, Rt):
    """Associative-scan RTS backward pass of a prepared affine model."""
    if c.shape[-1] > _PLANE_N:
        E, g0, L0 = _smooth_elements(F, c, Q, xt, Rt)
        _, g, L = associative_scan(lambda a, b: _smooth_combine(b, a),
                                   (E, g0, L0), reverse=True)
        return g, L
    g, L = _parallel_smooth_core_p(_m_split(F), _v_split(c), _m_split(Q),
                                   _v_split(xt), _m_split(Rt), xt.shape[0])
    return _v_join(g), _m_join(L)


def _parallel_smooth_core_p(Fp, cp, Qp, xtp, Ctp, T):
    return _scan_smooth_p(_smooth_elements_p(Fp, cp, Qp, xtp, Ctp, T))


def _affine_model(kf, u_seq, T, like, p=None):
    """(F, c) stacks of the dynamics, c_k = B_k u_k (zeros, in ``like``'s
    dtype and device, without an input); a callable is evaluated at each
    step's input and time with ``p`` (the filter's own by default)."""
    p = kf.p if p is None else p
    tvec = torch.arange(T, dtype=like.dtype, device=like.device) * kf.Ts
    m0 = kf.d0.mean
    F = _resolve_seq(kf.A, T, m0, u_seq, tvec, p, kf.Ts)
    B = _resolve_seq(kf.B, T, m0, u_seq, tvec, p, kf.Ts)
    if B is not None and u_seq.shape[-1]:
        c = _mv_t(B, u_seq)
    else:
        c = torch.zeros((T, m0.shape[-1]), dtype=like.dtype,
                        device=like.device)
    return F, c


def parallel_forward_trajectory(kf, u, y, p=None) -> KalmanFilteringSolution:
    """O(log T)-depth Kalman filtering pass.

    Matches ``forward_trajectory``'s sequential solution (x, xt, R, Rt,
    ll, e, S, K) for constant, time-stacked or callable system matrices
    that do not depend on the state; a callable is evaluated at the prior
    mean, and ``sol.ok`` is False at every step when one of them changes
    with the state (:func:`_state_indep_flag`).
    """
    from ..trajectory import _as_u_seq

    T = y.shape[0]
    u_seq = _as_u_seq(u, T, y.dtype, y.device)
    p = kf.p if p is None else p
    tvec = torch.arange(T, dtype=y.dtype, device=y.device) * kf.Ts
    m0, P0 = kf.d0.mean, kf.d0.cov
    F, c = _affine_model(kf, u_seq, T, y, p)
    H, D, Q, R = (_resolve_seq(M, T, m0, u_seq, tvec, p, kf.Ts)
                  for M in (kf.C, kf.D, kf.R1, kf.R2))
    y_eff = y - _mv_t(D, u_seq) if D is not None and u_seq.shape[-1] else y
    x_pred, R_pred, xt, Rt, e, S, Schol, K, lls = _parallel_filter_core(
        F, c, H, Q, R, y_eff, m0, P0)
    ok = torch.isfinite(xt).all(-1)
    for M in (kf.A, kf.B, kf.C, kf.D, kf.R1, kf.R2):
        flag = _state_indep_flag(M, m0, u_seq[0], p, tvec[0], kf.Ts)
        if flag is not None:
            ok = ok & flag
    return KalmanFilteringSolution(
        u=u_seq, y=y, x=x_pred, xt=xt, R=R_pred, Rt=Rt, ll=lls.sum(), e=e,
        K=K, S=S, extra=None, t=tvec, ok=ok,
        route=scan_route(xt.shape[-1], y.shape[-1], xt))


def parallel_rts_smooth(kf, u, y, p=None,
                        sol: Optional[KalmanFilteringSolution] = None
                        ) -> KalmanSmoothingSolution:
    """O(log T)-depth RTS smoother: the parallel filter pass, then a
    reverse associative scan (arXiv:1905.13002 §IV).  Matches the
    sequential smoother."""
    if sol is None:
        sol = parallel_forward_trajectory(kf, u, y, p)
    T = sol.y.shape[0]
    p = kf.p if p is None else p
    tvec = torch.arange(T, dtype=sol.y.dtype, device=sol.y.device) * kf.Ts
    F, c = _affine_model(kf, sol.u, T, sol.y, p)
    Q = _resolve_seq(kf.R1, T, kf.d0.mean, sol.u, tvec, p, kf.Ts)
    g, L = _parallel_smooth_core(F, c, Q, sol.xt, sol.Rt)
    return KalmanSmoothingSolution(sol=sol, xT=g, RT=L)


# ---------------------------------------------------------------------------
# Parallel iterated extended and sigma-point smoothers for nonlinear models
# (García-Fernández, Sarmavuori & Särkkä, "Parallel iterated extended and
# sigma-point Kalman smoothers"; the same associative operators)
# ---------------------------------------------------------------------------


def _nominal_inputs(f, u, y, p):
    """``(u_seq, tvec, p)`` as the iterated smoothers take them: no input
    is a [T, 0] tensor."""
    T = y.shape[0]
    u_seq = (torch.zeros((T, 0), dtype=y.dtype, device=y.device)
             if u is None else torch.as_tensor(u))
    tvec = torch.arange(T, dtype=y.dtype, device=y.device) * f.Ts
    return u_seq, tvec, (f.p if p is None else p)


def _smoothing_solution(u_seq, y, tvec, F, c, H, Q, R, y_eff, m0, P0):
    """The final pass of an iterated smoother on its last linearization:
    the filter and smoother cores and the solution containers."""
    x_pred, R_pred, xt, Rt, e, S, _, K, lls = _parallel_filter_core(
        F, c, H, Q, R, y_eff, m0, P0)
    xT, RT = _parallel_smooth_core(F, c, Q, xt, Rt)
    sol = KalmanFilteringSolution(
        u=u_seq, y=y, x=x_pred, xt=xt, R=R_pred, Rt=Rt, ll=lls.sum(), e=e,
        K=K, S=S, extra=None, t=tvec, ok=torch.isfinite(xT).all(-1),
        route=scan_route(xt.shape[-1], y.shape[-1], xt))
    return KalmanSmoothingSolution(sol=sol, xT=xT, RT=RT)


def parallel_iekf_smooth(ekf, u, y, p=None, *, iters: int = 8
                         ) -> KalmanSmoothingSolution:
    """O(log T)-depth iterated extended Kalman smoother.

    Gauss–Newton on the MAP trajectory: each iteration linearizes the
    dynamics and measurement along the current smoothed trajectory (an
    affine time-varying model) and runs the temporal-parallel filter and
    RTS smoother on it (kernel K on CUDA float32).  The fixed point is the
    iterated EKS trajectory; on affine models one pass is exact.  The
    refinement is a loop of ``iters − 1`` passes; the last pass builds
    the full solution, whose ``sol`` is the filtered solution of the final
    linearization.  Needs an EKF-shaped measurement model.
    """
    from ..kernels.ukf_scan import callbacks_affine

    mm = ekf.measurement_model
    if not hasattr(mm, "measurement"):
        raise TypeError("parallel_iekf_smooth needs an EKF-shaped "
                        "measurement model")
    T = y.shape[0]
    u_seq, tvec, p = _nominal_inputs(ekf, u, y, p)
    m0, P0 = ekf.d0.mean, ekf.d0.cov
    nx = m0.shape[-1]
    dyn, h = ekf.dynamics, mm.measurement
    Q, R = (_resolve_seq(M, T, m0, u_seq, tvec, p, ekf.Ts)
            for M in (ekf.R1, mm.R2))
    vm = torch.func.vmap

    def linearize(xbar):
        F = vm(lambda xk, uk, tk: ekf._Ajac(xk, uk, p, tk))(xbar, u_seq, tvec)
        fx = vm(lambda xk, uk, tk: dyn(xk, uk, p, tk))(xbar, u_seq, tvec)
        H = vm(lambda xk, uk, tk: mm._Cjac(xk, uk, p, tk))(xbar, u_seq, tvec)
        hx = vm(lambda xk, uk, tk: h(xk, uk, p, tk))(xbar, u_seq, tvec)
        return F, fx - _mv_t(F, xbar), H, y - (hx - _mv_t(H, xbar))

    # affine models: the linearization is exact and trajectory-
    # independent, so the single final pass is the fixed point
    if callbacks_affine(ekf, (dyn, h), torch.zeros_like(m0), u_seq[0], p,
                        tvec[0]):
        iters = 1
    # the initial nominal trajectory is the prior mean replicated: a
    # noiseless rollout would be a sequential T-step loop
    xbar = m0.expand(T, nx)
    if nx <= _PLANE_N and y.shape[-1] <= _PLANE_N:
        Qp, Rp = _m_split(Q), _m_split(R)
        for _ in range(iters - 1):
            F, c, H, y_eff = linearize(xbar)
            Fp, cp = _m_split(F), _v_split(c)
            xtp, Ctp = _filtered_moments_pp(Fp, cp, _m_split(H), Qp, Rp,
                                            _v_split(y_eff), m0, P0, T)
            xbar = _v_join(_parallel_smooth_core_p(Fp, cp, Qp, xtp, Ctp,
                                                   T)[0])
    else:
        for _ in range(iters - 1):
            F, c, H, y_eff = linearize(xbar)
            _, _, xt, Rt, *_ = _parallel_filter_core(F, c, H, Q, R, y_eff,
                                                     m0, P0)
            xbar = _parallel_smooth_core(F, c, Q, xt, Rt)[0]
    F, c, H, y_eff = linearize(xbar)
    return _smoothing_solution(u_seq, y, tvec, F, c, H, Q, R, y_eff, m0, P0)


def _slr_many(fns, m, P, W, params):
    """Statistical linear regression of several functions at the same
    N(m, P): the sigma points and the Cholesky factor of P are built once.
    Returns ``((F, c, Om) per function, sigma points)`` with
    ``F = Pxyᵀ P⁻¹``, ``c = ybar − F m``, ``Om = Pyy − F P Fᵀ``."""
    from ..models.sigmapoints import sigmapoints, ut_cov, ut_cross_cov, \
        ut_mean
    from ..ops.linalg import chol_solve

    xs = sigmapoints(m, P, params)
    Lc = chol_lower(symmetrize(P))

    def one(fn):
        ys = torch.func.vmap(fn)(xs)
        ybar = ut_mean(ys, W)
        Fk = chol_solve(Lc, ut_cross_cov(xs, m, ys, ybar, W)).mT
        Om = symmetrize(ut_cov(ys, ybar, W) - Fk @ P @ Fk.mT)
        return Fk, ybar - Fk @ m, Om

    return tuple(one(fn) for fn in fns), xs


def _slr_linearize_p(fns, out_dims, m_p, P_p, W, u_seq, tvec, p, T):
    """Plane form of :func:`_slr_many` along a trajectory of N(m_t, P_t)
    (the same formulas; the sigma points are m ± √W · columns of
    chol(P)).  Only the callback evaluation stacks [T, 2nx+1, ·] tensors;
    the moments, factorizations and regression solves are plane
    arithmetic."""
    nx = len(m_p)
    NP = 2 * nx + 1
    Lc = _chol_p(_sym_p(P_p))
    sW = float(W.W) ** 0.5
    pts = [tuple(m_p)]
    for i in range(nx):
        pts.append(tuple(m_p[q] + sW * Lc[q][i] for q in range(nx)))
    for i in range(nx):
        pts.append(tuple(m_p[q] - sW * Lc[q][i] for q in range(nx)))
    X3 = torch.stack([torch.stack(list(pt), -1) for pt in pts], 1)
    vm = torch.func.vmap
    dx = [tuple(pts[s][a] - m_p[a] for a in range(nx)) for s in range(NP)]
    outs = []
    for fn, nout in zip(fns, out_dims):
        ys = vm(lambda xrow, uk, tk: vm(lambda x: fn(x, uk, p, tk))(xrow))(
            X3, u_seq, tvec)
        ys_p = [tuple(ys[:, s, j] for j in range(nout)) for s in range(NP)]
        ybar = tuple(W.wm * ys_p[0][j]
                     + W.wmi * sum(ys_p[s][j] for s in range(1, NP))
                     for j in range(nout))
        dy = [tuple(ys_p[s][j] - ybar[j] for j in range(nout))
              for s in range(NP)]
        Pxy = tuple(tuple(
            W.wc * dx[0][a] * dy[0][b]
            + W.wci * sum(dx[s][a] * dy[s][b] for s in range(1, NP))
            for b in range(nout)) for a in range(nx))
        Pyy = tuple(tuple(
            W.wc * dy[0][a] * dy[0][b]
            + W.wci * sum(dy[s][a] * dy[s][b] for s in range(1, NP))
            for b in range(nout)) for a in range(nout))
        Fk = _mt_p(_chol_solve_p(Lc, Pxy))        # Pxyᵀ P⁻¹, [nout][nx]
        ck = _vsub_p(ybar, _mv_p(Fk, m_p))
        Om = _sym_p(_msub_p(Pyy, _mm_p(_mm_p(Fk, _sym_p(P_p)), _mt_p(Fk))))
        outs.append((Fk, ck, Om))
    return outs


def parallel_ukf_smooth(ukf, u, y, p=None, *, iters: int = 8
                        ) -> KalmanSmoothingSolution:
    """O(log T)-depth iterated sigma-point (posterior-linearization)
    Kalman smoother, the unscented counterpart of
    :func:`parallel_iekf_smooth`.

    Each iteration statistically linearizes the dynamics and measurement
    along the current smoothed trajectory and covariance (the unscented
    SLR), folding the residual covariances into R1 and R2, and runs the
    temporal-parallel filter and RTS smoother on that affine model.  On
    affine models the SLR is exact, so one Jacobian linearization and one
    pass are the fixed point and the sigma points are skipped; otherwise
    ``iters`` linearizations, each a plane pipeline for nx, ny <= 8.
    """
    from ..kernels.ukf_scan import callbacks_affine
    from ..models.sigmapoints import ukf_weights

    mm = ukf.measurement_model
    if not hasattr(mm, "measurement"):
        raise TypeError("parallel_ukf_smooth needs a UKF-shaped measurement "
                        "model")
    T, ny = y.shape
    u_seq, tvec, p = _nominal_inputs(ukf, u, y, p)
    m0, P0 = ukf.d0.mean, ukf.d0.cov
    nx = m0.shape[-1]
    params = ukf.weight_params
    W = ukf_weights(params, nx)
    dyn, h = ukf.dynamics, mm.measurement
    Q, R = (_resolve_seq(M, T, m0, u_seq, tvec, p, ukf.Ts)
            for M in (ukf.R1, mm.R2))
    vm = torch.func.vmap
    zx = torch.zeros_like(m0)

    if callbacks_affine(ukf, (dyn, h), zx, u_seq[0], p, tvec[0]):
        # the unscented SLR of an affine map is (Jacobian, fn(0), 0) for
        # any (m, P): one Jacobian linearization, one pass
        jac = torch.func.jacfwd
        F = vm(lambda uk, tk: jac(lambda x: dyn(x, uk, p, tk))(zx))(u_seq,
                                                                     tvec)
        c = vm(lambda uk, tk: dyn(zx, uk, p, tk))(u_seq, tvec)
        H = vm(lambda uk, tk: jac(lambda x: h(x, uk, p, tk))(zx))(u_seq,
                                                                   tvec)
        d = vm(lambda uk, tk: h(zx, uk, p, tk))(u_seq, tvec)
        return _smoothing_solution(u_seq, y, tvec, F, c, H, Q, R, y - d, m0,
                                   P0)
    if nx <= _PLANE_N and ny <= _PLANE_N:
        Qp, Rp, yp = _m_split(Q), _m_split(R), _v_split(y)

        def linearize_p(xb, Pb):
            (Fd, cd, Omf), (Fh, dh, Omh) = _slr_linearize_p(
                (dyn, h), (nx, ny), xb, Pb, W, u_seq, tvec, p, T)
            return (Fd, cd, _madd_p(Qp, Omf), Fh, _madd_p(Rp, Omh),
                    _vsub_p(yp, dh))

        xb = tuple(m0[i].expand(T) for i in range(nx))
        Pb = tuple(tuple(P0[i, j].expand(T) for j in range(nx))
                   for i in range(nx))
        for _ in range(iters - 1):
            Fp2, cp2, Qe, Hp2, Re, ye = linearize_p(xb, Pb)
            xtp, Ctp = _filtered_moments_pp(Fp2, cp2, Hp2, Qe, Re, ye, m0,
                                            P0, T)
            xb, Pb = _parallel_smooth_core_p(Fp2, cp2, Qe, xtp, Ctp, T)
        Fp2, cp2, Qe, Hp2, Re, ye = linearize_p(xb, Pb)
        xp, Rpred, xtp, Ctp, ep, Sp, _, Kp, lls = _parallel_filter_core_pp(
            Fp2, cp2, Hp2, Qe, Re, ye, m0, P0, T)
        gT, LT = _parallel_smooth_core_p(Fp2, cp2, Qe, xtp, Ctp, T)
        xT = _v_join(gT)
        xt = _v_join(xtp)
        sol = KalmanFilteringSolution(
            u=u_seq, y=y, x=_v_join(xp), xt=xt, R=_m_join(Rpred),
            Rt=_m_join(Ctp), ll=lls.sum(), e=_v_join(ep), K=_m_join(Kp),
            S=_m_join(Sp), extra=None, t=tvec,
            ok=torch.isfinite(xT).all(-1), route=scan_route(nx, ny, xt))
        return KalmanSmoothingSolution(sol=sol, xT=xT, RT=_m_join(LT))

    # wide states: the SLR vmapped over the steps on stacked tensors
    def linearize(xbar, Pbar):
        def one(mk, Pk, uk, tk):
            ((Fk, ck, Omf), (Hk, dk, Omh)), _ = _slr_many(
                (lambda x: dyn(x, uk, p, tk), lambda x: h(x, uk, p, tk)),
                mk, Pk, W, params)
            return Fk, ck, Omf, Hk, dk, Omh

        F, c, Omf, H, d, Omh = vm(one)(xbar, Pbar, u_seq, tvec)
        return F, c, Q + Omf, H, R + Omh, y - d

    xbar, Pbar = m0.expand(T, nx), P0.expand(T, nx, nx)
    for _ in range(iters - 1):
        F, c, Qe, H, Re, y_eff = linearize(xbar, Pbar)
        _, _, xt, Rt, *_ = _parallel_filter_core(F, c, H, Qe, Re, y_eff, m0,
                                                 P0)
        xbar, Pbar = _parallel_smooth_core(F, c, Qe, xt, Rt)
    F, c, Qe, H, Re, y_eff = linearize(xbar, Pbar)
    return _smoothing_solution(u_seq, y, tvec, F, c, H, Qe, Re, y_eff, m0, P0)
