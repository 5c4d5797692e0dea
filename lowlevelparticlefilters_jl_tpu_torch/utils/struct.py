"""Dataclass helper for filters, states and solutions.

Counterpart of ``lowlevelparticlefilters_jl_tpu/utils/struct.py``.  The
JAX package registers its dataclasses as pytrees, with static and leaf
fields, so that jit/grad/vmap see through them; PyTorch needs no
registry, so a ``struct`` here is a frozen dataclass over tensors with a
``replace`` method.
"""
from __future__ import annotations

import dataclasses
from typing import TypeVar

T = TypeVar("T")


def struct(cls: type[T]) -> type[T]:
    """Decorator: a frozen dataclass with ``replace(**updates)``."""
    cls = dataclasses.dataclass(frozen=True)(cls)

    def replace(self, **updates):
        return dataclasses.replace(self, **updates)

    cls.replace = replace
    return cls
