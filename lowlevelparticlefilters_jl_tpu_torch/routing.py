"""Dispatch of the plain verbs (counterpart of ``routing.py``).

Every verb takes ``method=``:

- ``"auto"`` (default): the fastest admitted path.  On CUDA tensors a
  particle filter's ``loglik`` runs kernel A, the whole recursion in one
  launch (kernels/pf_scan.py); a Kalman filter, and a UKF or EKF whose
  callbacks are affine in x, take the temporal-parallel path from
  ``T_PARALLEL`` steps on (kernel K, kernels/assoc_scan.py); everything
  else that is admitted takes its whole-scan kernel (G, H or I,
  kernels/ukf_scan.py).  On the CPU ``auto`` is the sequential loop.
- ``"sequential"``: the plain step loop, always.  It is the route that
  autograd differentiates; the kernels are forward-only.
- ``"fused"``: the whole-scan kernel when admitted (kernel A, or G, H, I)
  — on CPU tensors its plain twin.
- ``"parallel"``: the temporal-parallel path whenever the Kalman filter
  (or an affine UKF/EKF's equivalent KF) is admitted, on any device
  (kernel K on CUDA float32, the Hillis–Steele scan otherwise).

Under ``torch.func`` transforms (``vmap``, ``grad``, ``jvp``) every verb
takes the sequential route: a kernel reached through ``ctypes`` sees
only a wrapper tensor, not the batch or the tangents.

``last_route()`` names the path the most recent verb took:
``"cuda_fused_scan"``, ``"fused_scan_plain"``,
``"cuda_temporal_parallel"``, ``"temporal_parallel_plain"``,
``"sequential"``; the bank (filters/bank.py) records
``"cuda_bank_kernel"``, ``"bank_kernel_plain"``, ``"bank_plane"``,
``"bank_sequential"`` or ``"bank_vmap"`` under ``"kf_bank_loglik"``.
``smooth`` (smoothing.py) records a temporal-parallel route or
``"sequential"`` (:func:`route_smooth`), and the FFBS particle smoother
``"cuda_ffbs_kernel"`` (kernel J) or ``"ffbs_plain"``, under
``"smooth"``.  ``mean_trajectory`` of a particle filter records
``"cuda_fused_scan"`` (kernel A in its moments mode),
``"fused_scan_plain"`` or ``"sequential"`` under ``"mean_trajectory"``.
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


def route_pf_mean_trajectory(pf, u, y, p, generator, method: str):
    """The filtered means ``[T, nx]`` from kernel A's moments mode
    (``pf_mean_fused``) when wanted (CUDA tensors under ``"auto"``, or
    ``"fused"``) and admitted, with a generator and ``p`` unchanged;
    None (and ``"sequential"`` recorded) when ``forward_trajectory`` and
    the weighted mean should run."""
    from .kernels.pf_scan import kernel_admits, pf_mean_fused

    _check_method(method)
    wanted = method == "fused" or (method == "auto" and y.is_cuda)
    coef = None
    if (wanted and generator is not None
            and (p is None or p is getattr(pf, "p", None))
            and not _under_batch_trace(pf, u, y, p)):
        coef = kernel_admits(pf, u, y)
    if coef is None:
        _record("mean_trajectory", "sequential")
        return None
    means, _, _ = pf_mean_fused(pf, u, y, seed_from_generator(generator),
                                coef=coef)
    _record("mean_trajectory",
            "cuda_fused_scan" if y.is_cuda else "fused_scan_plain")
    return means


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


def _want_fused(method: str, y) -> bool:
    return method == "fused" or (method == "auto" and y.is_cuda)


def _affine_equiv_kf(f, u, y):
    """The exactly-equivalent plain KF of an affine UKF/EKF, for the
    temporal-parallel path: constant Jacobians (A, C) from the verdict of
    ``kernels/ukf_scan.py::affinity`` (static walk and probes, kept per
    filter), the callbacks' offsets as drive sequences fed through B = I
    and subtracted from y.  Returns ``(kf_eq, cs, y_eff)`` or None when
    out of scope."""
    from .filters.ekf import ExtendedKalmanFilter
    from .filters.kalman import KalmanFilter
    from .filters.ukf import UnscentedKalmanFilter
    from .kernels import ukf_scan as k
    from .ops.mvnormal import MvNormal

    if (type(f) not in (UnscentedKalmanFilter, ExtendedKalmanFilter)
            or u is not None and u.ndim != 2):
        return None
    v = k.affinity(f, 0 if u is None else u.shape[-1])
    if v.AC is None or float(v.ekf.alpha) != 1.0:
        return None
    ekf = v.ekf
    A, C = (M.to(y.device) for M in v.AC)
    y32 = y.to(torch.float32)
    cs, ds = k.drives(ekf, u, y.shape[0], y.device)
    f32 = lambda t: t.to(device=y.device, dtype=torch.float32)  # noqa: E731
    kf_eq = KalmanFilter(
        A, torch.eye(ekf.nx, dtype=torch.float32, device=y.device), C, 0,
        f32(ekf.R1), f32(ekf.measurement_model.R2),
        d0=MvNormal(f32(ekf.d0.mean), f32(ekf.d0.cov)), Ts=ekf.Ts,
        check=False)
    return kf_eq, cs, y32 - ds


def _route_kalman(verb, f, u, y, p, method):
    """The solution (``verb == "forward_trajectory"``) or ll of a Kalman-
    family filter through the temporal-parallel path or a whole-scan
    kernel when wanted and admitted, else None (and the sequential route
    recorded)."""
    from .filters.ekf import ExtendedKalmanFilter
    from .filters.kalman import KalmanFilter
    from .filters.ukf import UnscentedKalmanFilter
    from .kernels import ukf_scan as k
    from .parallel.temporal import parallel_forward_trajectory

    _check_method(method)
    traj = verb == "forward_trajectory"
    T = y.shape[0]
    if method == "sequential" or p is not None or _under_batch_trace(f, u, y):
        _record(verb, "sequential")
        return None
    if type(f) is KalmanFilter:
        if _want_parallel(method, y, T) and _kf_parallel_ok(f, T):
            sol = parallel_forward_trajectory(f, u, y)
            _record(verb, sol.route)
            return sol if traj else sol.ll
        out = k._ekf_fused(f, y, u, want_traj=traj, allow_cpu=True) \
            if _want_fused(method, y) else None
    else:
        if _want_parallel(method, y, T):
            eq = _affine_equiv_kf(f, u, y)
            if eq is not None:
                kf_eq, cs, y_eff = eq
                sol = parallel_forward_trajectory(kf_eq, cs, y_eff)
                _record(verb, sol.route)
                if not traj:
                    return sol.ll
                from .trajectory import _as_u_seq

                y32 = y.to(torch.float32)
                return sol.replace(u=_as_u_seq(u, T, y32.dtype, y.device),
                                   y=y32)
        out = None
        if _want_fused(method, y):
            if type(f) is UnscentedKalmanFilter:
                out = k._ukf_fused(f, y, u, want_traj=traj, allow_cpu=True,
                                   pin_g=False)
            elif type(f) is ExtendedKalmanFilter:
                out = k._ekf_fused(f, y, u, want_traj=traj, allow_cpu=True)
    if out is None:
        _record(verb, "sequential")
    return out


def route_kalman_loglik(f, u, y, p, method: str):
    """The log-likelihood of a KF, UKF or EKF through the temporal-
    parallel path or a whole-scan kernel, or None for the sequential
    recursion."""
    return _route_kalman("loglik", f, u, y, p, method)


def route_forward_trajectory(f, u, y, p, method: str):
    """The filtering solution of a KF, UKF or EKF through the temporal-
    parallel path or a whole-scan kernel, or None for the sequential
    recursion."""
    return _route_kalman("forward_trajectory", f, u, y, p, method)


def route_smooth(f, u, y, p, method: str, kwargs: dict):
    """The temporal-parallel smoothers for a long trajectory: a plain KF
    goes to ``parallel_rts_smooth``; a UKF (nx <= 8, additive dynamics)
    to ``parallel_ukf_smooth`` and an EKF (nx <= 8) to
    ``parallel_iekf_smooth``, the iterated smoothers, exact in one pass on
    affine models.  Wanted on CUDA tensors from ``T_PARALLEL`` steps on,
    or with ``method="parallel"``.  Returns None (and records
    ``"sequential"`` under ``"smooth"``) for the sequential backward
    pass."""
    from .filters.ekf import ExtendedKalmanFilter
    from .filters.kalman import KalmanFilter
    from .filters.ukf import UnscentedKalmanFilter
    from .parallel import temporal

    _check_method(method)
    T = y.shape[0]
    fn = None
    if (method != "sequential" and not kwargs
            and not _under_batch_trace(f, u, y, p)
            and _want_parallel(method, y, T)):
        if type(f) is KalmanFilter and _kf_parallel_ok(f, T):
            fn = temporal.parallel_rts_smooth
        elif p is None and type(f) is UnscentedKalmanFilter and f.nx <= 8 \
                and not f.augmented_dynamics:
            fn = temporal.parallel_ukf_smooth
        elif p is None and type(f) is ExtendedKalmanFilter and f.nx <= 8:
            fn = temporal.parallel_iekf_smooth
    if fn is None:
        _record("smooth", "sequential")
        return None
    sm = fn(f, u, y, p)
    _record("smooth", sm.sol.route)
    return sm
