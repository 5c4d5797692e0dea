"""Checkpoint and resume for filter states, solutions and PMMH chains
(counterpart of ``utils/checkpoint.py``).

The format is the JAX package's: one ``.npz`` whose keys are the paths of
the leaves joined by ``/`` (a dataclass field by its name, a tuple or
list item by its index, a dict entry as ``['key']``), so a file written by
one package loads in the other for the same structure.  The port's
structs are walked by their dataclass fields.  A ``torch.Generator`` (the
particle filter's ``PFState.generator``, where the JAX package keeps a
key) is saved as its ``get_state()`` bytes under its own path, so that a
resumed filter continues the same random stream.  Values that are
neither tensors, numbers nor generators (a solution's ``route``) are not
saved; ``load_pytree`` keeps them from ``like``, as the JAX package keeps
its static fields.  A Python number (a state's step count ``t``, a leaf
in the JAX package) is saved and restored.
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from .struct import tree_map_with_path


def _walk(tree, fn: Callable):
    """``tree`` with ``fn(name, leaf)`` for each leaf, ``name`` its path
    joined by ``/``."""
    return tree_map_with_path(
        lambda path, leaf: fn("/".join(path) or "leaf", leaf), tree)


def _savable(leaf) -> bool:
    return isinstance(leaf, (torch.Tensor, torch.Generator, np.ndarray,
                             int, float)) and not isinstance(leaf, bool)


def _flatten_with_paths(tree) -> dict:
    out = {}

    def take(name, leaf):
        if isinstance(leaf, torch.Generator):
            out[name] = leaf.get_state().numpy()
        elif isinstance(leaf, torch.Tensor):
            out[name] = leaf.detach().cpu().numpy()
        elif _savable(leaf):
            out[name] = np.asarray(leaf)
        return leaf

    _walk(tree, take)
    return out


def save_pytree(path: str, tree: Any, *, use_orbax: bool = False) -> None:
    """Write a state or solution to ``path`` as a flat ``.npz`` of its
    leaves.  ``use_orbax=True`` raises: orbax is a JAX library."""
    if use_orbax:
        raise NotImplementedError(
            "use_orbax=True: orbax-checkpoint is a JAX library; the PyTorch "
            "port writes the .npz format only (use_orbax=False)")
    np.savez(path, **_flatten_with_paths(tree))


def load_pytree(path: str, like: Any, *, use_orbax: bool = False) -> Any:
    """Restore a structure saved by :func:`save_pytree` (or by the JAX
    package's) into the shape of ``like``: every tensor on the device and
    in the dtype of ``like``'s leaf; a Python number (a step count) of the
    type of ``like``'s; a generator restored into a new one on the device
    of ``like``'s (a JAX file has none: ``like``'s is kept).  What the
    file does not save (``route``, None) is kept from ``like``."""
    if use_orbax:
        raise NotImplementedError(
            "use_orbax=True: orbax-checkpoint is a JAX library; the PyTorch "
            "port reads the .npz format only (use_orbax=False)")
    def put(name, leaf):
        if isinstance(leaf, torch.Tensor):
            return torch.from_numpy(np.array(data[name])).to(
                device=leaf.device, dtype=leaf.dtype)
        if name not in data.files:
            return leaf
        if isinstance(leaf, torch.Generator):
            g = torch.Generator(device=leaf.device)
            g.set_state(torch.from_numpy(np.array(data[name])))
            return g
        if isinstance(leaf, np.ndarray):
            return np.array(data[name])
        if _savable(leaf):          # a Python step count or scale
            return type(leaf)(data[name].item())
        return leaf

    with np.load(path if str(path).endswith(".npz")
                 else str(path) + ".npz") as data:
        return _walk(like, put)


def resume_state(f, path: str, generator=None) -> Any:
    """A saved state of filter ``f``, its structure from
    ``f.init(generator)``; a particle filter's saved random stream is
    restored on ``generator``'s device, so pass one to continue it."""
    return load_pytree(path, f.init(generator))
