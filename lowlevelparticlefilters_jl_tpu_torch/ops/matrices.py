"""The `get_mat` convention: constant, time-stacked or callable matrices
(counterpart of ``ops/matrices.py``).

A system matrix is

- a constant tensor,
- a time-stacked tensor whose leading axis is the step index (``M[k]`` is
  the matrix at step ``k``), or a :class:`TimeVarying` wrapper around
  such a stack,
- a callable ``M(x, u, p, t) -> tensor``, kept in a :class:`FnMat`, or
- an :class:`IndexingMatrix`, a 0/1 selector applied as a gather.
"""
from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from ..utils.struct import struct


@struct
class TimeVarying:
    """Explicit marker for a time-stacked matrix ``data[k] = M_k``."""

    data: torch.Tensor


@struct
class FnMat:
    """A callable matrix spec ``fn(x, u, p, t)``."""

    fn: Callable

    def __call__(self, x, u, p, t):
        return self.fn(x, u, p, t)


def as_matspec(M):
    """Coerce a user matrix spec: tensors, :class:`TimeVarying`,
    :class:`FnMat` and indexing matrices pass through, another callable is
    wrapped in :class:`FnMat`, arrays become tensors, ``None`` passes
    through."""
    if M is None or isinstance(M, (torch.Tensor, TimeVarying, FnMat,
                                   IndexingMatrix, TransposedIndexingMatrix)):
        return M
    if callable(M):
        return FnMat(fn=M)
    return torch.as_tensor(M)


def resolve_mat(M, x, u, p, t, *, base_ndim: int = 2, Ts: float = 1.0):
    """Evaluate a matrix spec at ``(x, u, p, t)``.  A callable receives the
    wall time ``t``; a tensor of rank ``base_ndim + 1`` is time-stacked
    and indexed at the integer step ``round(t / Ts)``; an indexing matrix
    is returned as it is."""
    if M is None or isinstance(M, (IndexingMatrix,
                                   TransposedIndexingMatrix)):
        return M
    if isinstance(M, TimeVarying):
        return _index_time(M.data, t, Ts)
    if callable(M):
        return M(x, u, p, t)
    if M.ndim == base_ndim + 1:
        return _index_time(M, t, Ts)
    return M


def _index_time(data: torch.Tensor, t, Ts: float = 1.0) -> torch.Tensor:
    tq = float(t) / Ts
    if abs(tq - round(tq)) > 1e-4:
        raise ValueError(
            "resolve_mat: a time-stacked (3-D) matrix is indexed by the "
            f"integer step but got t/Ts = {tq}. Pass the matrix as a "
            "function M(x, u, p, t) if it must be evaluated at non-integer "
            "time points.")
    return data[int(round(tq))]


def is_constant_mat(M, base_ndim: int = 2) -> bool:
    """True when ``M`` resolves to the same matrix for every
    ``(x, u, p, t)``."""
    if M is None or isinstance(M, (IndexingMatrix,
                                   TransposedIndexingMatrix)):
        return True
    if isinstance(M, (TimeVarying, FnMat)) or callable(M):
        return False
    return torch.as_tensor(M).ndim <= base_ndim


# ---------------------------------------------------------------------------
# IndexingMatrix: a sparse 0/1 selector, applied as a gather or a scatter
# ---------------------------------------------------------------------------


@struct
class IndexingMatrix:
    """An (m, n) selector with exactly one 1 a row: ``I @ v`` gathers
    ``v[inds]``, ``I.T @ v`` scatter-adds, and the dense matrix is never
    formed on the way."""

    inds: torch.Tensor  # int64 [m]: row i selects column inds[i]
    n: int

    @property
    def shape(self):
        return (self.inds.shape[0], self.n)

    def todense(self, dtype=torch.float32, device=None) -> torch.Tensor:
        device = self.inds.device if device is None else device
        return torch.nn.functional.one_hot(
            self.inds.to(device), self.n).to(dtype)

    def matvec(self, v: torch.Tensor) -> torch.Tensor:
        """``I @ v``: a gather along the leading axis of ``v``."""
        return torch.index_select(v, 0, self.inds.to(v.device))

    def rmatvec(self, v: torch.Tensor) -> torch.Tensor:
        """``I.T @ v``: a scatter-add along the leading axis of ``v``."""
        out = v.new_zeros((self.n, *v.shape[1:]))
        return out.index_add(0, self.inds.to(v.device), v)

    def __matmul__(self, other):
        return self.matvec(torch.as_tensor(other))

    def __rmatmul__(self, other):
        # other @ I == (I.T @ other.T).T: a column scatter-add
        other = torch.as_tensor(other)
        return self.rmatvec(other.movedim(-1, 0)).movedim(0, -1)

    @property
    def T(self) -> "TransposedIndexingMatrix":
        """The lazy transpose, so that ``R @ C.T`` and ``C @ R @ C.T`` in a
        Kalman update stay gathers."""
        return TransposedIndexingMatrix(base=self)


@struct
class TransposedIndexingMatrix:
    """``I.T``: ``I.T @ v`` scatter-adds, ``M @ I.T`` gathers columns."""

    base: IndexingMatrix

    @property
    def shape(self):
        m, n = self.base.shape
        return (n, m)

    @property
    def T(self) -> IndexingMatrix:
        return self.base

    def todense(self, dtype=torch.float32, device=None) -> torch.Tensor:
        return self.base.todense(dtype, device).T

    def __matmul__(self, other):
        return self.base.rmatvec(torch.as_tensor(other))

    def __rmatmul__(self, other):
        # M @ I.T: result[..., j] = M[..., inds[j]], a column gather
        other = torch.as_tensor(other)
        return torch.index_select(other, -1, self.base.inds.to(other.device))


def indexing_matrix(inds, n: int,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> IndexingMatrix:
    """The (len(inds), n) selector whose row i picks column ``inds[i]``."""
    return IndexingMatrix(inds=torch.as_tensor(inds, dtype=torch.int64,
                                               device=device), n=int(n))


MatLike = Union[torch.Tensor, TimeVarying, FnMat, IndexingMatrix,
                Callable, None]
