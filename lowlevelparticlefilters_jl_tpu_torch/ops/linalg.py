"""Small dense linear-algebra helpers (counterpart of ``ops/linalg.py``).

Same unrolled Cholesky and triangular-solve formulas as the JAX package
for dimensions up to 8, so the two agree to the last few ulps in
float64; larger matrices go to ``torch.linalg``.  All helpers broadcast
over leading batch axes.
"""
from __future__ import annotations

import torch

_UNROLL_N = 8


def symmetrize(X: torch.Tensor) -> torch.Tensor:
    """0.5 (X + X^T) over the trailing two axes."""
    return 0.5 * (X + X.transpose(-1, -2))


def _chol_unrolled(S: torch.Tensor) -> torch.Tensor:
    """Cholesky–Banachiewicz with the dimension unrolled.  A matrix that
    is not positive definite yields NaNs instead of an exception, as in
    the JAX package."""
    n = S.shape[-1]
    L = [[None] * n for _ in range(n)]
    zero = torch.zeros_like(S[..., 0, 0])
    for i in range(n):
        for j in range(i + 1):
            s = S[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = torch.sqrt(s) if i == j else s / L[j][j]
    rows = [torch.stack([L[i][j] if j <= i else zero for j in range(n)], -1)
            for i in range(n)]
    return torch.stack(rows, -2)


def _tri_solve_unrolled(L: torch.Tensor, B: torch.Tensor, *,
                        lower: bool) -> torch.Tensor:
    """Unrolled forward/back substitution; ``B``: [..., n, m]."""
    n = L.shape[-1]
    order = range(n) if lower else range(n - 1, -1, -1)
    z: list = [None] * n
    for i in order:
        s = B[..., i, :]
        ks = range(i) if lower else range(i + 1, n)
        for k in ks:
            s = s - L[..., i, k, None] * z[k]
        z[i] = s / L[..., i, i, None]
    return torch.stack(z, -2)


def chol_lower(S: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of the symmetrized ``S``."""
    S = symmetrize(S)
    if S.shape[-1] <= _UNROLL_N:
        return _chol_unrolled(S)
    return torch.linalg.cholesky(S)


def tri_solve(L: torch.Tensor, B: torch.Tensor, *,
              lower: bool = True) -> torch.Tensor:
    """Solve ``L X = B`` for triangular ``L``; ``B``: [..., n, m]."""
    if L.shape[-1] <= _UNROLL_N:
        return _tri_solve_unrolled(L, B, lower=lower)
    return torch.linalg.solve_triangular(L, B, upper=not lower)


def _lu_solve_unrolled(M: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Unrolled Gaussian elimination without pivoting, batched over
    leading axes.  Safe only where the leading principal minors are well
    away from zero, e.g. ``I + C J`` with C, J PSD (every eigenvalue
    >= 1), the associative-scan combine's system.  ``B``: [..., n, m]."""
    n = M.shape[-1]
    rowsM = [M[..., i, :] for i in range(n)]
    rowsB = [B[..., i, :] for i in range(n)]
    for k in range(n):
        pivM, pivB = rowsM[k], rowsB[k]
        piv = pivM[..., k:k + 1]
        for i in range(k + 1, n):
            f = rowsM[i][..., k:k + 1] / piv
            rowsM[i] = rowsM[i] - f * pivM
            rowsB[i] = rowsB[i] - f * pivB
    X: list = [None] * n
    for i in range(n - 1, -1, -1):
        acc = rowsB[i]
        for j in range(i + 1, n):
            acc = acc - rowsM[i][..., j:j + 1] * X[j]
        X[i] = acc / rowsM[i][..., i:i + 1]
    return torch.stack(X, -2)


def solve_nopivot(M: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``M X = B`` by unrolled no-pivot elimination up to n = 8 (the
    caller guarantees pivot safety, see :func:`_lu_solve_unrolled`), by
    ``torch.linalg.solve`` above."""
    if M.shape[-1] <= _UNROLL_N:
        return _lu_solve_unrolled(M, B)
    return torch.linalg.solve(M, B)


def chol_solve(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve (L L^T) X = B given the lower Cholesky factor L."""
    y = tri_solve(L, B, lower=True)
    return tri_solve(L.transpose(-1, -2), y, lower=False)


def rdiv_chol(B: torch.Tensor, L: torch.Tensor) -> torch.Tensor:
    """B (L L^T)^{-1} — the reference's ``B / Schol`` idiom."""
    return chol_solve(L, B.transpose(-1, -2)).transpose(-1, -2)


def logdet_chol(L: torch.Tensor) -> torch.Tensor:
    """log det(L L^T) = 2 sum(log diag L)."""
    return 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
