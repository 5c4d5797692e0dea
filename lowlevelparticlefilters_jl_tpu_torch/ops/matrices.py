"""The `get_mat` convention: constant or time-stacked matrices
(counterpart of ``ops/matrices.py``).

A system matrix is a constant tensor, a time-stacked tensor whose
leading axis is the step index (``M[k]`` is the matrix at step ``k``),
or a :class:`TimeVarying` wrapper around such a stack.  The callable
form (``FnMat``) of the JAX package is not ported yet.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from ..utils.struct import struct


@struct
class TimeVarying:
    """Explicit marker for a time-stacked matrix ``data[k] = M_k``."""

    data: torch.Tensor


MatLike = Union[torch.Tensor, TimeVarying, None]


def as_matspec(M) -> Optional[Union[torch.Tensor, TimeVarying]]:
    """Coerce a user matrix spec: tensors and TimeVarying pass through,
    arrays become tensors, ``None`` passes through."""
    if M is None or isinstance(M, (torch.Tensor, TimeVarying)):
        return M
    if callable(M):
        raise NotImplementedError(
            "callable system matrices are not supported by the PyTorch "
            "port yet; pass a constant or a [T, ...] time-stacked tensor")
    return torch.as_tensor(M)


def resolve_mat(M: MatLike, x, u, p, t, *, base_ndim: int = 2,
                Ts: float = 1.0):
    """Evaluate a matrix spec at time ``t``.  A tensor of rank
    ``base_ndim + 1`` is time-stacked and indexed at the integer step
    ``round(t / Ts)``."""
    if M is None:
        return None
    if isinstance(M, TimeVarying):
        return _index_time(M.data, t, Ts)
    if M.ndim == base_ndim + 1:
        return _index_time(M, t, Ts)
    return M


def _index_time(data: torch.Tensor, t, Ts: float = 1.0) -> torch.Tensor:
    tq = float(t) / Ts
    if abs(tq - round(tq)) > 1e-4:
        raise ValueError(
            "resolve_mat: a time-stacked (3-D) matrix is indexed by the "
            f"integer step but got t/Ts = {tq}.")
    return data[int(round(tq))]

