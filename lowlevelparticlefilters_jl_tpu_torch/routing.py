"""Dispatch of the plain verbs (counterpart of ``routing.py``).

Every verb takes ``method=``:

- ``"auto"`` (default): the fastest admitted path.  For a particle
  filter on CUDA tensors that is kernel A, the whole recursion in one
  launch (kernels/pf_scan.py); on the CPU it is the sequential loop, as
  the JAX package runs the scan off the TPU.
- ``"sequential"``: the plain step loop, always.  It is the route that
  autograd differentiates; the kernels are forward-only.
- ``"fused"``: kernel A when admitted — on CPU tensors its plain twin.
- ``"parallel"``: accepted for compatibility; the temporal-parallel
  paths are not ported yet, so it runs the sequential loop.

Admission into kernel A is decided per call and recorded:
``last_route()`` names the path the most recent verb took —
``"cuda_fused_scan"``, ``"fused_scan_plain"`` or ``"sequential"``.
"""
from __future__ import annotations

from typing import Optional

import torch

_LAST: dict = {}

METHODS = ("auto", "sequential", "fused", "parallel")


def _record(verb: str, path: str) -> None:
    _LAST[verb] = path
    _LAST["last"] = path


def last_route(verb: str = "last") -> Optional[str]:
    """The execution path the most recent verb dispatched to."""
    return _LAST.get(verb)


def _check_method(method: str) -> None:
    if method not in METHODS:
        raise ValueError(f"method must be one of {METHODS}, got {method!r}")


def seed_from_generator(generator) -> int:
    """A 63-bit seed for the Philox kernels, drawn from ``generator``
    (None: PyTorch's default generator) — the counterpart of the JAX
    package's ``seed_from_key``."""
    device = generator.device if generator is not None else "cpu"
    return int(torch.randint(0, 2**63 - 1, (), generator=generator,
                             device=device))


def route_pf_loglik(pf, u, y, p, generator, state0, method: str):
    """Kernel A for the bootstrap-PF log-likelihood when admitted;
    returns None when the sequential loop should run."""
    from .kernels.pf_scan import kernel_admits, pf_loglik_fused

    _check_method(method)
    wanted = method == "fused" or (method == "auto" and y.is_cuda)
    if (not wanted or state0 is not None
            or (p is not None and p is not getattr(pf, "p", None))):
        _record("loglik", "sequential")
        return None
    coef = kernel_admits(pf, u, y)
    if coef is None:
        _record("loglik", "sequential")
        return None
    ll, _ = pf_loglik_fused(pf, u, y, seed_from_generator(generator),
                            coef=coef)
    _record("loglik", "cuda_fused_scan" if y.is_cuda else "fused_scan_plain")
    return ll


def route_kalman_loglik(f, u, y, p, method: str) -> None:
    """The KF's fused and temporal-parallel routes reach kernels that are
    not ported yet, so every KF loglik runs the sequential recursion."""
    _check_method(method)
    _record("loglik", "sequential")
