"""Banks of filtering passes on ``torch.func.vmap`` (counterpart of
``parallel/bank.py``).

One filter runs over a bank of trajectories, ``u`` [B, T, nu] and ``y``
[B, T, ny]: the per-step small matrix products become batched ones.
Under ``vmap`` the verbs take the sequential route (routing.py), which
``vmap`` batches.  For a shared linear model ``kf_bank_loglik``
(filters/bank.py) is faster: it computes the Riccati recursion once.
Across processes, :func:`bank_mesh` and :func:`shard_bank` give each rank
of a ``torch.distributed`` group its block of the bank (the banks run
without communication).
"""
from __future__ import annotations

import torch

from ..utils.solutions import KalmanFilteringSolution


def bank_mesh(group=None, device=None):
    """The 1-D mesh of ``group`` for a bank (parallel/sharded.py's
    :func:`~.sharded.particle_mesh`)."""
    from .sharded import particle_mesh

    return particle_mesh(group, device=device)


def shard_bank(tree, mesh):
    """This rank's block of a bank-stacked structure on the mesh's
    device: every tensor (in tuples, lists, dicts and dataclass fields)
    sliced on its leading (bank) axis, which must divide by the mesh
    size."""
    import dataclasses

    def place(x):
        if isinstance(x, torch.Tensor):
            if x.shape[0] % mesh.size:
                raise ValueError(f"a bank of {x.shape[0]} is not divisible "
                                 f"by {mesh.size} ranks")
            n = x.shape[0] // mesh.size
            return x[mesh.rank * n:(mesh.rank + 1) * n].to(mesh.device)
        if isinstance(x, (tuple, list)):
            return type(x)(place(v) for v in x)
        if isinstance(x, dict):
            return {k: place(v) for k, v in x.items()}
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return dataclasses.replace(x, **{
                f.name: place(getattr(x, f.name))
                for f in dataclasses.fields(x) if f.init})
        return x

    return place(tree)


def _in_dims(in_axes):
    if in_axes[0] is not None:
        raise NotImplementedError(
            "vmap over a stacked filter is not ported; pass in_axes="
            "(None, ...) and one filter for the whole bank")
    return tuple(in_axes[1:])


def bank_loglik(f, u, y, p=None, *, in_axes=(None, 0, 0), **kwargs):
    """Log-likelihood of each trajectory of the bank: ``[B]``.
    ``in_axes`` follows ``vmap`` over ``(filter, u, y)``; ``u`` may be
    shared (``in_axes[1] = None``).  Differentiable: the sequential route
    runs under ``vmap``."""
    from ..trajectory import loglik

    return torch.func.vmap(lambda ui, yi: loglik(f, ui, yi, p, **kwargs),
                           in_dims=_in_dims(in_axes))(u, y)


_SOL_FIELDS = ("u", "y", "x", "xt", "R", "Rt", "ll", "e", "K", "S", "t",
               "ok")


def bank_forward_trajectory(f, u, y, p=None, *, in_axes=(None, 0, 0),
                            **kwargs) -> KalmanFilteringSolution:
    """A Kalman filter's forward pass over each trajectory of the bank;
    every field of the solution gains a leading bank axis."""
    from ..trajectory import forward_trajectory

    def one(ui, yi):
        sol = forward_trajectory(f, ui, yi, p, **kwargs)
        return tuple(getattr(sol, k) for k in _SOL_FIELDS)

    outs = torch.func.vmap(one, in_dims=_in_dims(in_axes))(u, y)
    return KalmanFilteringSolution(**dict(zip(_SOL_FIELDS, outs)),
                                   route="sequential")

