"""Banks of filtering passes on ``torch.func.vmap`` (counterpart of
``parallel/bank.py``).

One filter runs over a bank of trajectories, ``u`` [B, T, nu] and ``y``
[B, T, ny]: the per-step small matrix products become batched ones.
Under ``vmap`` the verbs take the sequential route (routing.py), which
``vmap`` batches.  A bank of filters that differ in their tensors (a
bank of 1024 KFs with different R1) is stacked by :func:`stack_filters`
and run with ``in_axes=(0, 0, 0)``.  For a shared linear model
``kf_bank_loglik`` (filters/bank.py) is faster: it computes the Riccati
recursion once.
Across processes, :func:`bank_mesh` and :func:`shard_bank` give each rank
of a ``torch.distributed`` group its block of the bank (the banks run
without communication).
"""
from __future__ import annotations

import copy

import torch

from ..ops.matrices import FnMat, IndexingMatrix, TransposedIndexingMatrix
from ..utils.solutions import KalmanFilteringSolution
from ..utils.struct import (tree_children, tree_leaves,
                            tree_map_with_path)


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
    def place(_, x):
        if not isinstance(x, torch.Tensor):
            return x
        if x.shape[0] % mesh.size:
            raise ValueError(f"a bank of {x.shape[0]} is not divisible "
                             f"by {mesh.size} ranks")
        n = x.shape[0] // mesh.size
        return x[mesh.rank * n:(mesh.rank + 1) * n].to(mesh.device)

    return tree_map_with_path(place, tree)


def _stack(vals: list, name: str):
    """The members' values of one field stacked on a new leading axis;
    values that are not tensors must be the same in every member."""
    v0 = vals[0]
    if isinstance(v0, (FnMat, IndexingMatrix, TransposedIndexingMatrix)):
        raise ValueError(f"field {name!r}: a {type(v0).__name__} cannot be "
                         "stacked; give the filters tensor matrices")
    if isinstance(v0, torch.Tensor):
        if any(not isinstance(v, torch.Tensor) or v.shape != v0.shape
               for v in vals):
            raise ValueError(f"field {name!r}: the members' tensors differ "
                             "in shape or kind")
        return torch.stack(vals)
    if any(type(v) is not type(v0) for v in vals):
        raise ValueError(f"field {name!r}: the members differ in kind")
    kids = tree_children(v0)
    if kids is not None:
        every = [tree_children(v) for v in vals]
        if any([k for k, _ in kv] != [k for k, _ in kids] for kv in every):
            raise ValueError(f"field {name!r}: the members differ in "
                             "structure")
        form = ("{}[{}]" if isinstance(v0, (tuple, list)) else "{}{}"
                if isinstance(v0, dict) else "{}.{}")
        out = [_stack([kv[i][1] for kv in every], form.format(name, k))
               for i, (k, _) in enumerate(kids)]
        if isinstance(v0, dict):
            return dict(zip(v0.keys(), out))
        if isinstance(v0, (tuple, list)):
            return type(v0)(*out) if hasattr(v0, "_fields") \
                else type(v0)(out)
        # a container for the bank verbs: the constructor does not run on
        # the stacked tensors
        st = copy.copy(v0)
        for (k, _), v in zip(kids, out):
            object.__setattr__(st, k, v)
        return st
    if any(v is not v0 and v != v0 for v in vals):
        raise ValueError(f"field {name!r}: the members differ in a value "
                         "that is not a tensor (a callable or a setting), "
                         "which cannot be stacked")
    return v0


def stack_filters(filters):
    """B filters of one type and structure as one, each tensor field (in
    nested densities too) stacked on a new leading axis of length B: the
    counterpart of ``jax.tree_util.tree_map(jnp.stack, *filters)``, for
    ``bank_loglik(..., in_axes=(0, ...))``.  Callables (a callable system
    matrix, a member's own callback) and indexing matrices cannot be
    stacked: a ``ValueError`` names the field.  The result holds the
    stacked tensors; it is a container for the bank verbs, not a filter
    to run by itself."""
    filters = list(filters)
    if not filters:
        raise ValueError("stack_filters needs at least one filter")
    return _stack(filters, type(filters[0]).__name__)


def _vmap_members(fn, f, u, y, in_axes):
    """``fn(member, u_i, y_i)`` under ``torch.func.vmap`` over the bank:
    over the stacked filter's tensors too where ``in_axes[0]`` is 0."""
    if in_axes[0] is None:
        return torch.func.vmap(lambda ui, yi: fn(f, ui, yi),
                               in_dims=tuple(in_axes[1:]))(u, y)
    if in_axes[0] != 0:
        raise ValueError(f"in_axes[0] must be None or 0, got {in_axes[0]}")

    def member(leaves, ui, yi):
        # each dataclass that holds a tensor is built again from the
        # member's slices, so its constructor runs on them (and skips its
        # checks under vmap)
        it = iter(leaves)
        fi = tree_map_with_path(
            lambda _, x: next(it) if isinstance(x, torch.Tensor) else x, f)
        return fn(fi, ui, yi)

    return torch.func.vmap(member, in_dims=(0,) + tuple(in_axes[1:]))(
        tree_leaves(f), u, y)


def bank_loglik(f, u, y, p=None, *, in_axes=(None, 0, 0), **kwargs):
    """Log-likelihood of each trajectory of the bank: ``[B]``.
    ``in_axes`` follows ``vmap`` over ``(filter, u, y)``: ``u`` may be
    shared (``in_axes[1] = None``), and ``in_axes[0] = 0`` runs a filter
    stacked by :func:`stack_filters`, member b on trajectory b.
    Differentiable, through the stacked tensors too: the sequential route
    runs under ``vmap``."""
    from ..trajectory import loglik

    return _vmap_members(lambda fi, ui, yi: loglik(fi, ui, yi, p, **kwargs),
                         f, u, y, in_axes)


_SOL_FIELDS = ("u", "y", "x", "xt", "R", "Rt", "ll", "e", "K", "S", "t",
               "ok")


def bank_forward_trajectory(f, u, y, p=None, *, in_axes=(None, 0, 0),
                            **kwargs) -> KalmanFilteringSolution:
    """A Kalman filter's forward pass over each trajectory of the bank
    (``in_axes`` as in :func:`bank_loglik`); every field of the solution
    gains a leading bank axis."""
    from ..trajectory import forward_trajectory

    def one(fi, ui, yi):
        sol = forward_trajectory(fi, ui, yi, p, **kwargs)
        return tuple(getattr(sol, k) for k in _SOL_FIELDS)

    outs = _vmap_members(one, f, u, y, in_axes)
    return KalmanFilteringSolution(**dict(zip(_SOL_FIELDS, outs)),
                                   route="sequential")

