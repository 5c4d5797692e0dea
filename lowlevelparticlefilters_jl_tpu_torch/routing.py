"""Dispatch of the plain verbs (counterpart of ``routing.py``).

Every verb takes ``method=``:

- ``"auto"`` (default): the fastest admitted path.  On CUDA tensors a
  particle filter's ``loglik`` runs kernel A, the whole recursion in one
  launch (kernels/pf_scan.py), and a Kalman filter's ``loglik`` and
  ``forward_trajectory`` take the temporal-parallel path from
  ``T_PARALLEL`` steps on (kernel K, kernels/assoc_scan.py).  On the CPU
  ``auto`` is the sequential loop.
- ``"sequential"``: the plain step loop, always.  It is the route that
  autograd differentiates; the kernels are forward-only.
- ``"fused"``: kernel A when admitted — on CPU tensors its plain twin.
  The Kalman filter's fused kernel is not ported, so its ``"fused"`` is
  sequential.
- ``"parallel"``: the temporal-parallel path whenever the Kalman filter
  is admitted, on any device (kernel K on CUDA float32, the Hillis–Steele
  scan otherwise).

Under ``torch.func`` transforms (``vmap``, ``grad``, ``jvp``) every verb
takes the sequential route: a kernel reached through ``ctypes`` sees
only a wrapper tensor, not the batch or the tangents.

``last_route()`` names the path the most recent verb took:
``"cuda_fused_scan"``, ``"fused_scan_plain"``,
``"cuda_temporal_parallel"``, ``"temporal_parallel_plain"``,
``"sequential"``; the bank (filters/bank.py) records
``"cuda_bank_kernel"``, ``"bank_kernel_plain"``, ``"bank_plane"``,
``"bank_sequential"`` or ``"bank_vmap"`` under ``"kf_bank_loglik"``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

_LAST: dict = {}

METHODS = ("auto", "sequential", "fused", "parallel")

#: shortest trajectory that ``method="auto"`` sends down the temporal-
#: parallel path on CUDA tensors (the JAX package's threshold)
T_PARALLEL = 256


def _record(verb: str, path: str) -> None:
    _LAST[verb] = path
    _LAST["last"] = path


def last_route(verb: str = "last") -> Optional[str]:
    """The execution path the most recent verb dispatched to."""
    return _LAST.get(verb)


def _check_method(method: str) -> None:
    if method not in METHODS:
        raise ValueError(f"method must be one of {METHODS}, got {method!r}")


def _tensor_leaves(v):
    if isinstance(v, torch.Tensor):
        yield v
    elif isinstance(v, (tuple, list)):
        for x in v:
            yield from _tensor_leaves(x)
    elif dataclasses.is_dataclass(v) and not isinstance(v, type):
        for f in dataclasses.fields(v):
            yield from _tensor_leaves(getattr(v, f.name))


def _under_batch_trace(*vals) -> bool:
    """True when a tensor among ``vals`` (filters and densities are
    searched field by field) is wrapped by a ``torch.func`` transform —
    ``vmap``'s batched tensors, ``grad``'s and ``jvp``'s tracking ones.
    The kernels cannot run on such tensors, so the verb takes the
    sequential route, which the transform batches or differentiates."""
    wrapped = torch._C._functorch.is_functorch_wrapped_tensor
    return any(wrapped(t) for t in _tensor_leaves(vals))


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
            or (p is not None and p is not getattr(pf, "p", None))
            or _under_batch_trace(pf, u, y, p)):
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


def _kf_parallel_ok(kf, T: int) -> bool:
    """Admission for the temporal-parallel KF: a plain ``KalmanFilter``
    with alpha = 1, no R12, nx, ny <= 8 and at least 2 steps."""
    from .filters.kalman import KalmanFilter

    if type(kf) is not KalmanFilter:
        return False
    if not isinstance(kf.alpha, (int, float)) or float(kf.alpha) != 1.0:
        return False
    return kf.R12 is None and kf.nx <= 8 and kf.ny <= 8 and T >= 2


def _want_parallel(method: str, y, T: int) -> bool:
    if method == "parallel":
        return True
    return method == "auto" and y.is_cuda and T >= T_PARALLEL


def _route_kalman(verb, f, u, y, p, method):
    """The temporal-parallel solution when wanted and admitted, else None
    (and the sequential route recorded)."""
    from .parallel.temporal import parallel_forward_trajectory

    _check_method(method)
    T = y.shape[0]
    if (p is None and _want_parallel(method, y, T) and _kf_parallel_ok(f, T)
            and not _under_batch_trace(f, u, y)):
        sol = parallel_forward_trajectory(f, u, y)
        _record(verb, sol.route)
        return sol
    _record(verb, "sequential")
    return None


def route_kalman_loglik(f, u, y, p, method: str):
    """The KF log-likelihood through the temporal-parallel path, or None
    for the sequential recursion."""
    sol = _route_kalman("loglik", f, u, y, p, method)
    return None if sol is None else sol.ll


def route_forward_trajectory(f, u, y, p, method: str):
    """The KF solution through the temporal-parallel path, or None for
    the sequential recursion."""
    return _route_kalman("forward_trajectory", f, u, y, p, method)
