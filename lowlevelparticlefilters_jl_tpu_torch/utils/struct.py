"""Dataclass helper for filters, states and solutions.

Counterpart of ``lowlevelparticlefilters_jl_tpu/utils/struct.py``.  The
JAX package registers its dataclasses as pytrees, with static and leaf
fields, so that jit/grad/vmap see through them; PyTorch needs no
registry, so a ``struct`` here is a frozen dataclass over tensors with a
``replace`` method, and the tree rules that the JAX package gets from
``jax.tree_util`` are here: a tuple or a list holds its items, a dict its
values, a dataclass its fields; anything else (a tensor, a generator, a
callable, None) is a leaf.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, TypeVar

import torch

T = TypeVar("T")


def struct(cls: type[T]) -> type[T]:
    """Decorator: a frozen dataclass with ``replace(**updates)``."""
    cls = dataclasses.dataclass(frozen=True)(cls)

    def replace(self, **updates):
        return dataclasses.replace(self, **updates)

    cls.replace = replace
    return cls


def tree_children(tree) -> Optional[list]:
    """The ``(key, child)`` pairs of a container, None for a leaf: a
    dataclass field by its name, a tuple or list item by its index, a dict
    entry as ``['key']`` (the JAX package's path names)."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f.name, getattr(tree, f.name))
                for f in dataclasses.fields(tree) if f.init]
    if isinstance(tree, (tuple, list)):
        return [(str(i), v) for i, v in enumerate(tree)]
    if isinstance(tree, dict):
        return [(f"[{k!r}]", v) for k, v in tree.items()]
    return None


def tree_map_with_path(fn: Callable, tree, path: tuple = ()) -> Any:
    """``tree`` with every leaf replaced by ``fn(path, leaf)``, ``path``
    the tuple of keys from the root.  A container whose leaves all come
    back as they were is returned itself; one that changed is built
    again, a dataclass by ``dataclasses.replace``, so that its
    constructor runs on the new leaves."""
    kids = tree_children(tree)
    if kids is None:
        return fn(path, tree)
    vals = [tree_map_with_path(fn, v, path + (k,)) for k, v in kids]
    if all(v is old for v, (_, old) in zip(vals, kids)):
        return tree
    if isinstance(tree, dict):
        return dict(zip(tree.keys(), vals))
    if isinstance(tree, (tuple, list)):
        return type(tree)(*vals) if hasattr(tree, "_fields") \
            else type(tree)(vals)
    return dataclasses.replace(tree, **{k: v for (k, _), v in
                                        zip(kids, vals)})


def tree_leaves(tree) -> list:
    """The tensors of ``tree``, depth first in :func:`tree_children`'s
    order (that of :func:`tree_map_with_path`)."""
    kids = tree_children(tree)
    if kids is None:
        return [tree] if isinstance(tree, torch.Tensor) else []
    return [t for _, v in kids for t in tree_leaves(v)]
