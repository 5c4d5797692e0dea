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
from ..ops.matrices import TimeVarying
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


def _resolve_seq(M, T: int) -> Optional[torch.Tensor]:
    """A matrix spec as a [T, ...] stack: a constant is expanded, a
    time-stacked tensor (or :class:`TimeVarying`) gives its first T
    steps, as ``resolve_mat`` indexes it at step k.  The callable form
    (``FnMat``) is not ported, so nothing here depends on the state."""
    if M is None:
        return None
    data = M.data if isinstance(M, TimeVarying) else M
    if data.ndim == 2:
        return data.expand(T, *data.shape)
    if data.shape[0] < T:
        raise ValueError(f"a time-stacked matrix has {data.shape[0]} steps, "
                         f"the data {T}")
    return data[:T]


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


def _scan_filter_p(elems_p):
    """Inclusive filter-combine scan of plane elements: kernel K on CUDA
    f32 with nx <= 8 (kernels/assoc_scan.py), its Hillis–Steele twin
    elsewhere.  Returns (xt planes, Rt planes)."""
    from ..kernels import assoc_scan as k

    if k.scan_supported(len(elems_p[1]), elems_p[1][0]):
        return k.filter_scan_p(elems_p)
    return k.filter_scan_p_plain(elems_p)


def _scan_smooth_p(elems_p):
    """The reverse smooth-combine scan: (xT planes, RT planes)."""
    from ..kernels import assoc_scan as k

    if k.scan_supported(len(elems_p[1]), elems_p[1][0]):
        return k.smooth_scan_p(elems_p)
    return k.smooth_scan_p_plain(elems_p)


def scan_route(nx: int, ny: int, like: torch.Tensor) -> str:
    """The route name of a temporal-parallel pass over elements of
    ``like``'s dtype and device: ``"cuda_temporal_parallel"`` when kernel
    K takes the scans, ``"temporal_parallel_plain"`` otherwise."""
    from ..kernels.assoc_scan import scan_supported

    planes = nx <= _PLANE_N and ny <= _PLANE_N
    return ("cuda_temporal_parallel" if planes and scan_supported(nx, like)
            else "temporal_parallel_plain")


def _parallel_filter_core_p(F, c, H, Q, R, y_eff, m0, P0):
    """Plane-pipeline filter on stacked [T, ...] tensors (split once
    here); see :func:`_parallel_filter_core_pp`."""
    return _parallel_filter_core_pp(
        _m_split(F), _v_split(c), _m_split(H), _m_split(Q), _m_split(R),
        _v_split(y_eff), m0, P0, y_eff.shape[0])


def _parallel_filter_core_pp(Fp, cp, Hp, Qp, Rp, yp, m0, P0, T):
    """Plane-pipeline filter: returns ``(xp, Rp_pred, xtp, Ctp, ep, Sp,
    Schp, Kp, lls)``, all plane structures except the [T] tensor
    ``lls``."""
    ny = len(yp)
    elems = _filter_elements_p(Fp, cp, Hp, Qp, Rp, yp, m0, P0, T)
    xtp, Ctp = _scan_filter_p(elems)

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


def _affine_model(kf, u_seq, T, like):
    """(F, c) stacks of the dynamics, c_k = B_k u_k (zeros, in ``like``'s
    dtype and device, without an input)."""
    nx = kf.d0.mean.shape[-1]
    F = _resolve_seq(kf.A, T)
    B = _resolve_seq(kf.B, T)
    if B is not None and u_seq.shape[-1]:
        c = _mv_t(B, u_seq)
    else:
        c = torch.zeros((T, nx), dtype=like.dtype, device=like.device)
    return F, c


def parallel_forward_trajectory(kf, u, y, p=None) -> KalmanFilteringSolution:
    """O(log T)-depth Kalman filtering pass.

    Matches ``forward_trajectory``'s sequential solution (x, xt, R, Rt,
    ll, e, S, K) for constant or time-stacked system matrices.  ``p`` is
    accepted for the verb's signature; tensor matrices do not read it.
    """
    from ..trajectory import _as_u_seq

    T = y.shape[0]
    u_seq = _as_u_seq(u, T, y.dtype, y.device)
    m0, P0 = kf.d0.mean, kf.d0.cov
    F, c = _affine_model(kf, u_seq, T, y)
    H = _resolve_seq(kf.C, T)
    D = _resolve_seq(kf.D, T)
    Q = _resolve_seq(kf.R1, T)
    R = _resolve_seq(kf.R2, T)
    y_eff = y - _mv_t(D, u_seq) if D is not None and u_seq.shape[-1] else y
    x_pred, R_pred, xt, Rt, e, S, Schol, K, lls = _parallel_filter_core(
        F, c, H, Q, R, y_eff, m0, P0)
    return KalmanFilteringSolution(
        u=u_seq, y=y, x=x_pred, xt=xt, R=R_pred, Rt=Rt, ll=lls.sum(), e=e,
        K=K, S=S, extra=None,
        t=torch.arange(T, dtype=y.dtype, device=y.device) * kf.Ts,
        ok=torch.isfinite(xt).all(-1),
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
    F, c = _affine_model(kf, sol.u, T, sol.y)
    Q = _resolve_seq(kf.R1, T)
    g, L = _parallel_smooth_core(F, c, Q, sol.xt, sol.Rt)
    return KalmanSmoothingSolution(sol=sol, xT=g, RT=L)
