"""Whole-scan Kalman-family kernels G, H and I (counterpart of
``ops/pallas/ukf_scan.py``).

Each kernel runs the whole correct-then-predict recursion over T steps
in one launch:

- **G** (``csrc/ukf_scan.cuh``, kind UKF): the additive-noise UKF, with
  the user's ``innovation``, ``mean`` and ``state_mean`` hooks;
- **H** (``csrc/akf_scan.cu``): the affine KF with constant Jacobians
  A, C, the drives ``c_t = f(0, u_t, t)``, ``d_t = g(0, u_t, t)`` as data,
  and the Riccati recursion frozen once it is stationary: a serial prefix
  up to the freeze (:func:`akf_freeze_step`), then the remaining linear
  recursion as a chunked parallel scan; it serves
  ``KalmanFilter.loglik_fused`` and every affine UKF/EKF;
- **I** (``csrc/ukf_scan.cuh``, kind EKF): the EKF with per-step
  Jacobians from the user's ``Ajac``/``Cjac`` or by forward mode.

G and I compile the user callbacks in: ``callback_codegen`` lowers each
one to scalar C++ and ``_lib.build_generated`` builds one small library
per filter at first use; the trace and the library are cached per filter
object and input width.  H's inputs are all data, so it lives in the main
library.  Admission follows the JAX package (``_supported``,
``_ekf_supported``, ``_const_affine_kf_params``, ``_affine_ekf_equivalent``):
affinity in x by a static walk of the lowered callbacks
(``callback_codegen.affine_in``, the counterpart of the jaxpr walk),
constant Jacobians by concrete ``torch.func.jacfwd`` probes, one verdict
per filter (:func:`affinity`), float32 filters and data, and nx, ny <= 8.
A filter out of scope takes the sequential route.  On CUDA tensors an
admitted filter launches its kernel or raises; CPU tensors take each
kernel's plain twin, the same recursion as a loop of PyTorch ops
(``*_scan_plain``).
"""
from __future__ import annotations

import contextlib
import time
import weakref
from dataclasses import dataclass, field
from typing import Optional

import torch

from ..models.sigmapoints import ukf_weights
from ..ops.linalg import chol_lower, symmetrize, tri_solve
from ..utils.solutions import KalmanFilteringSolution
from . import callback_codegen as cg
from ._lib import (KernelInfo, build_generated, check, library,
                   require_cuda_f32, stream_ptr)

UKF_SCAN = KernelInfo(
    "ukf_scan", "lowlevelparticlefilters_jl_tpu_torch/csrc/ukf_scan.cuh",
    "lowlevelparticlefilters_jl_tpu/ops/pallas/ukf_scan.py:353")
AKF_SCAN = KernelInfo(
    "akf_scan", "lowlevelparticlefilters_jl_tpu_torch/csrc/akf_scan.cu",
    "lowlevelparticlefilters_jl_tpu/ops/pallas/ukf_scan.py:739")
EKF_SCAN = KernelInfo(
    "ekf_scan", "lowlevelparticlefilters_jl_tpu_torch/csrc/ukf_scan.cuh",
    "lowlevelparticlefilters_jl_tpu/ops/pallas/ukf_scan.py:1087")

_LOG2PI = 1.8378770664093453
#: relative step-to-step movement of the prior covariance below which
#: kernel H freezes the Riccati recursion (the JAX kernel's _FTOL)
FTOL = 1e-7
MAX_DIM = 8
_FIELDS = ("x", "R", "xt", "Rt", "e", "S", "K")


@contextlib.contextmanager
def _no_tf32():
    """Full float32 matrix products for the probes and the drives."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


# ---------------------------------------------------------------------------
# Static admission
# ---------------------------------------------------------------------------


def _const2d(M) -> bool:
    return isinstance(M, torch.Tensor) and M.ndim == 2


def _f32(*ts) -> bool:
    return all(t is None or t.dtype == torch.float32 for t in ts)


def _dims_ok(f) -> bool:
    return 1 <= f.nx <= MAX_DIM and 1 <= f.measurement_model.ny <= MAX_DIM


def _default_hooks(ukf, mm) -> bool:
    """True when the UT mean/innovation hooks are all default — the
    precondition of the affine reroutes."""
    return (mm.innovation is None and mm.mean is None
            and getattr(ukf, "state_mean", None) is None)


def _supported(ukf, mm) -> bool:
    """Static scope of kernel G: additive noise on both sides, a
    ``UKFMeasurementModel`` without covariance overrides, constant R1 and
    R2, the default factorization, no rejection, float32 and nx, ny <= 8.
    The callbacks and hooks are admitted when they lower
    (:func:`_ukf_programs`)."""
    from ..models.measurement_models import UKFMeasurementModel

    return (not getattr(ukf, "augmented_dynamics", False)
            and isinstance(mm, UKFMeasurementModel) and not mm.augmented
            and mm.cov is None and mm.cross_cov is None
            and getattr(ukf, "state_cov", None) is None
            and _const2d(ukf.R1) and _const2d(mm.R2)
            and getattr(ukf, "cholesky_fn", None) is None
            and getattr(ukf, "reject", None) is None
            and _dims_ok(ukf) and _f32(ukf.R1, mm.R2, ukf.d0.mean,
                                      ukf.d0.cov))


def _ekf_supported(ekf, mm) -> bool:
    """Static scope of kernels H and I: a plain ``EKFMeasurementModel``
    without R12, constant R1 and R2, a scalar alpha, float32 and nx,
    ny <= 8."""
    from ..models.measurement_models import EKFMeasurementModel

    return (type(mm) is EKFMeasurementModel and mm.R12 is None
            and _const2d(ekf.R1) and _const2d(mm.R2)
            and not callable(getattr(ekf, "alpha", 1.0))
            and _dims_ok(ekf) and _f32(ekf.R1, mm.R2, ekf.d0.mean,
                                      ekf.d0.cov))


# ---------------------------------------------------------------------------
# Affinity (static walk) and constant Jacobians (concrete probes): kernel
# H's admission, one verdict per filter
# ---------------------------------------------------------------------------


def _probe_inputs(nx: int, nu: int, Ts: float, dtype, device):
    """The JAX package's probe points: inputs 0 and 0.7 + 0.31 k, times
    0 and 17 Ts, states 0, cos(1 + 2.399963 k) and sin(0.5 + 1.618034 k)."""
    k = lambda n: torch.arange(n, dtype=torch.float64)  # noqa: E731
    mk = lambda v: v.to(dtype=dtype, device=device)  # noqa: E731
    us = ([mk(torch.zeros(nu)), mk(0.7 + 0.31 * k(nu))] if nu > 0
          else [mk(torch.zeros(0))])
    ts = [mk(torch.tensor(0.0)), mk(torch.tensor(17.0 * Ts))]
    xs = [mk(torch.zeros(nx)), mk(torch.cos(1.0 + 2.399963 * k(nx))),
          mk(torch.sin(0.5 + 1.618034 * k(nx)))]
    return us, ts, xs


def _jacobians(fn, jac_user, us, ts, xs, p):
    """Jacobians of ``fn`` at every (u, t, x) probe, or None when the
    affine identity ``fn(x) = J x + fn(0)`` fails at one of them."""
    mats = []
    for u_ in us:
        for t_ in ts:
            f0 = fn(xs[0], u_, p, t_)
            for x_ in xs:
                J = (jac_user(x_, u_, p, t_) if jac_user is not None else
                     torch.func.jacfwd(lambda xx: fn(xx, u_, p, t_))(x_))
                lin = J @ x_ + f0
                tol = 1e-5 * (1.0 + float(lin.abs().max()))
                if float((fn(x_, u_, p, t_) - lin).abs().max()) > tol:
                    return None
                mats.append(J)
    return mats


def _filter_nu(f) -> int:
    return max(int(getattr(f, "nu", 0)), 0)


def callback_affine_in_x(fn, x0, u0, p, t0) -> Optional[cg.Program]:
    """Static check that ``fn(x, u, p, t)`` is affine in x for every u
    and t (the JAX package's ``_callback_affine_in_x``): the callback
    lowered at the example inputs and walked by
    :func:`callback_codegen.affine_in`.  Returns the program when it is
    affine, else None; a callback that does not lower is not affine."""
    prog = cg.lower_or_none(lambda x, u, t: fn(x, u, p, t), (x0, u0, t0),
                            "Sff", "walk")
    return prog if prog is not None and cg.affine_in(prog) else None


def _affine_programs(f, fns, nu: int) -> Optional[list]:
    """The callbacks ``fns`` of filter ``f`` lowered at its device, or None
    when one does not lower or is not affine in x for every input and
    time (:func:`callback_affine_in_x`)."""
    x0, u0, t0 = _examples(f, nu, f.d0.mean.device)
    progs = [callback_affine_in_x(fn, x0, u0, f.p, t0) for fn in fns]
    return None if any(prog is None for prog in progs) else progs


def callbacks_affine(f, fns, x0, u0, p, t0) -> bool:
    """True when every callback of ``fns`` is affine in x
    (:func:`callback_affine_in_x` at the example inputs ``x0, u0, t0``).
    With the filter's own ``p`` the verdict is kept per filter, input
    width, type and device, and made again after a change in place to a
    tensor the callbacks close over."""
    def make():
        progs = []
        for fn in fns:
            prog = callback_affine_in_x(fn, x0, u0, p, t0)
            if prog is None:
                return False, ()
            progs.append(prog)
        return True, tuple((c, c._version) for pr in progs
                           for c in pr.consts)

    if p is not getattr(f, "p", None):
        return make()[0]
    key = ("affine_in_x", tuple(u0.shape), x0.dtype, str(x0.device))
    return _cached(f, key, make, lambda v: any(
        c._version != ver for c, ver in v[1]))[0]


def _const_jacobians(ekf, mm, nx: int, nu: int):
    """The probes of :func:`_const_affine_kf_params` alone."""
    dtype, device = ekf.d0.mean.dtype, ekf.d0.mean.device
    us, ts, xs = _probe_inputs(nx, nu, float(ekf.Ts), dtype, device)
    out = []
    try:
        with _no_tf32():
            for fn, jac in ((ekf.dynamics, getattr(ekf, "Ajac", None)),
                            (mm.measurement, getattr(mm, "Cjac", None))):
                mats = _jacobians(fn, jac, us, ts, xs, ekf.p)
                if mats is None or not all(torch.equal(mats[0], m)
                                           for m in mats[1:]):
                    return None
                out.append(mats[0].detach().to(torch.float32).contiguous())
    except Exception:  # a callback the probes cannot evaluate
        return None
    return tuple(out)


def _const_affine_kf_params(ekf, mm, nx: int, nu: Optional[int] = None):
    """Constant ``(A, C)`` float32 Jacobians of an EKF whose callbacks are
    affine in x (the static walk) with Jacobians that do not change with
    the state, the input or the time (concrete probes); None otherwise
    (then kernel I runs)."""
    nu = _filter_nu(ekf) if nu is None else nu
    if _affine_programs(ekf, (ekf.dynamics, mm.measurement), nu) is None:
        return None
    return _const_jacobians(ekf, mm, nx, nu)


def _equivalent_ekf(ukf, mm, nu: int):
    from ..filters.ekf import make_ekf

    ekf = make_ekf(ukf.dynamics, mm.measurement, ukf.R1, mm.R2, d0=ukf.d0,
                   nu=nu, ny=ukf.ny, Ts=ukf.Ts, p=ukf.p)
    return ekf if _ekf_supported(ekf, ekf.measurement_model) else None


def _affine_ekf_equivalent(ukf, mm, nx: int, nu: Optional[int] = None):
    """The exactly-equivalent EKF of a UKF whose callbacks are affine in
    x (the static walk; the unscented transform is exact there), or
    None."""
    if not _default_hooks(ukf, mm):
        return None  # a manifold UT is not the EKF even on affine maps
    nu = _filter_nu(ukf) if nu is None else nu
    if _affine_programs(ukf, (ukf.dynamics, mm.measurement), nu) is None:
        return None
    return _equivalent_ekf(ukf, mm, nu)


@dataclass
class Affinity:
    """One filter's verdict for kernels H and I.  ``ekf``: the EKF they
    run — the filter itself, a ``KalmanFilter``'s delegate or an affine
    UKF's equivalent — or None (kernel G or the sequential route);
    ``AC``: its constant float32 Jacobians when kernel H admits it;
    ``watch``: the tensors the callbacks close over, with their versions
    when the verdict was reached."""

    ekf: object
    AC: Optional[tuple]
    watch: tuple = ()

    def stale(self) -> bool:
        return any(t._version != v for t, v in self.watch)


def affinity(f, nu: int) -> Affinity:
    """The verdict for filter ``f`` (a ``KalmanFilter``, an EKF or a UKF
    inside kernel G's scope) at input width ``nu``: the static walk and
    the probes run once per filter and width, and again after a change in
    place to a tensor the callbacks close over."""
    from ..filters.kalman import KalmanFilter
    from ..filters.ukf import UnscentedKalmanFilter

    def make():
        is_ukf = type(f) is UnscentedKalmanFilter
        ekf = f._fused_delegate() if type(f) is KalmanFilter else f
        if ekf is None:
            return Affinity(None, None)
        mm = ekf.measurement_model
        if is_ukf and not (_supported(f, mm) and _default_hooks(f, mm)):
            return Affinity(None, None)
        if not is_ukf and not _ekf_supported(ekf, mm):
            return Affinity(None, None)
        progs = _affine_programs(ekf, (ekf.dynamics, mm.measurement), nu)
        if progs is None:  # I runs an EKF, G a UKF
            return Affinity(None if is_ukf else ekf, None)
        if is_ukf:
            ekf = _equivalent_ekf(f, mm, nu)
            if ekf is None:
                return Affinity(None, None)
        AC = _const_jacobians(ekf, ekf.measurement_model, ekf.nx, nu)
        return Affinity(ekf, AC, tuple((c, c._version) for p in progs
                                       for c in p.consts))
    return _cached(f, ("affinity", nu), make, Affinity.stale)


def drives(ekf, us: Optional[torch.Tensor], T: int, device):
    """``c_t = f(0, u_t, t)`` [T, nx] and ``d_t = g(0, u_t, t)`` [T, ny]
    in float32, each in one batched call of the callback."""
    nx = ekf.nx
    p, mm = ekf.p, ekf.measurement_model
    dtype = ekf.d0.mean.dtype
    tvec = torch.arange(T, dtype=dtype, device=device) * float(ekf.Ts)
    zx = torch.zeros(nx, dtype=dtype, device=device)
    u = (us.to(dtype) if us is not None and us.shape[-1] > 0 else
         torch.zeros(T, 0, dtype=dtype, device=device))
    vm = torch.func.vmap
    with _no_tf32():
        cs = vm(lambda u_, t_: ekf.dynamics(zx, u_, p, t_))(u, tvec)
        ds = vm(lambda u_, t_: mm.measurement(zx, u_, p, t_))(u, tvec)
    return (cs.to(torch.float32).contiguous(),
            ds.to(torch.float32).contiguous())


def live_drives(cs, ds):
    """``(cs, ds)`` with an all-zero drive replaced by None, so that
    kernel H does not read it (the JAX kernel's ``has_c``/``has_d``);
    one synchronization for both."""
    has_c, has_d = torch.stack([cs.any(), ds.any()]).tolist()
    return (cs if has_c else None), (ds if has_d else None)


# ---------------------------------------------------------------------------
# Callback programs and their libraries (kernels G and I)
# ---------------------------------------------------------------------------


@dataclass
class Compiled:
    """One filter's lowered callbacks for kernel G or I at one input
    width, with the library built from them at first launch."""

    kind: str                      # "UKF" or "EKF"
    nx: int
    ny: int
    nu: int
    progs: list                    # (switch, Program) in constants order
    trace_seconds: float
    build_seconds: float = 0.0
    lib: object = field(default=None, repr=False)
    layout: str = ""               # G's sigma-point layout (ukf_layout)

    def source(self) -> str:
        names = {name for name, _ in self.progs}
        lines = ["// generated by lowlevelparticlefilters_jl_tpu_torch/"
                 "kernels/ukf_scan.py",
                 f"#define LLPF_{self.kind} 1",
                 f"#define LLPF_NX {self.nx}", f"#define LLPF_NY {self.ny}",
                 f"#define LLPF_NU {self.nu}",
                 f"#define LLPF_NC {sum(p.n_consts for _, p in self.progs)}"]
        if self.kind == "UKF":
            lanes = 1 if self.layout == "thread" else 32
            lines.append(f"#define LLPF_UKF_LANES {lanes}")
        for name, switch in (("cb_inn", "HOOK_INN"), ("cb_mean", "HOOK_MEAN"),
                             ("cb_smean", "HOOK_SMEAN")):
            lines.append(f"#define LLPF_{switch} {int(name in names)}")
        lines.append('#include "callback_ops.cuh"')
        base = 0
        for _, prog in self.progs:
            lines.append(prog.cpp(base))
            base += prog.n_consts
        lines.append('#include "ukf_scan.cuh"')
        return "\n".join(lines) + "\n"

    def consts(self, device) -> torch.Tensor:
        """The callbacks' constants, read now (one float32 buffer)."""
        bufs = [prog.const_buffer(device) for _, prog in self.progs]
        out = torch.cat(bufs) if bufs else torch.zeros(0, device=device)
        return out if out.numel() else torch.zeros(1, device=device)

    def library(self):
        if self.lib is None:
            t0 = time.perf_counter()
            self.lib = build_generated(self.source())
            self.build_seconds = time.perf_counter() - t0
        return self.lib


# id(filter) -> (weak reference to it, {(kind, nu, device): Compiled or
# None}); an entry leaves with its filter
_TRACES: dict = {}


def _cached(f, key, make, stale=None):
    entry = _TRACES.get(id(f))
    if entry is None or entry[0]() is not f:
        entry = _TRACES[id(f)] = (weakref.ref(f), {})
        weakref.finalize(f, _TRACES.pop, id(f), None)
    if key not in entry[1] or (stale is not None and stale(entry[1][key])):
        entry[1][key] = make()
    return entry[1][key]


def _examples(f, nu: int, device):
    z = lambda *s: torch.zeros(*s, dtype=torch.float32, device=device)  # noqa
    return z(f.nx), z(nu), torch.tensor(0.0, dtype=torch.float32,
                                        device=device)


def _lower_all(specs) -> Optional[list]:
    """Lower ``(name, fn, examples, kinds, out_shape)`` specs; None when
    one is not admitted or has the wrong output shape."""
    progs = []
    for name, fn, ex, kinds, shape in specs:
        prog = cg.lower_or_none(fn, ex, kinds, name)
        if prog is None or prog.out_shape != shape:
            return None
        progs.append((name, prog))
    return progs


def _ekf_programs(ekf, nu: int, device) -> Optional[Compiled]:
    """Kernel I's callbacks as value-and-Jacobian programs ``cb_fvj`` and
    ``cb_gvj``: each callback with the user's Jacobian, or with its own
    Jacobian in x differentiated at code generation; traced once per
    filter, input width and device; None when not admitted."""
    def make():
        t0 = time.perf_counter()
        mm, p, nx, ny = ekf.measurement_model, ekf.p, ekf.nx, ekf.ny
        ex = _examples(ekf, nu, device)
        progs = []

        def bound(fn):
            return lambda x, u, t: fn(x, u, p, t)

        for name, fn, jac, m in (("cb_fvj", ekf.dynamics, ekf.Ajac, nx),
                                 ("cb_gvj", mm.measurement, mm.Cjac, ny)):
            specs = [(name, bound(fn), ex, "Sff", (m,))]
            if jac is not None:
                specs.append((name, bound(jac), ex, "Sff", (m, nx)))
            lowered = _lower_all(specs)
            if lowered is None:
                return None
            value = lowered[0][1]
            progs.append((name, value.jacobian(name=name) if jac is None
                          else cg.concat(name, [value, lowered[1][1]])))
        return Compiled("EKF", nx, ny, nu, progs, time.perf_counter() - t0)
    return _cached(ekf, ("EKF", nu, str(device)), make)


#: the largest nx whose 2 nx + 1 sigma points kernel G evaluates on one
#: thread: faster than the warp layout at nx = 2 and 4, far slower at 8
#: (register spills), on the H100 (PERF.md)
UKF_THREAD_MAX_NX = 4


def ukf_layout(nx: int) -> str:
    """Kernel G's sigma-point layout for ``nx`` states: ``"thread"``, one
    thread evaluates every point and the UT moments are register sums,
    for nx <= :data:`UKF_THREAD_MAX_NX`; else ``"warp"``, lane k evaluates
    point k and the moments are shuffle butterflies (fewer registers a
    thread at 17 points)."""
    return "thread" if nx <= UKF_THREAD_MAX_NX else "warp"


def _ukf_programs(ukf, nu: int, device) -> Optional[Compiled]:
    """Kernel G's lowered callbacks (f, g and the UT hooks), with the
    sigma-point layout of :func:`ukf_layout`."""
    def make():
        t0 = time.perf_counter()
        mm, p, nx, ny = ukf.measurement_model, ukf.p, ukf.nx, ukf.ny
        W = ukf_weights(ukf.weight_params, nx)
        ex = _examples(ukf, nu, device)
        z = lambda *s: torch.zeros(*s, dtype=torch.float32,  # noqa: E731
                                   device=device)
        nsig = 2 * nx + 1
        specs = [("cb_f", lambda x, u, t: ukf.dynamics(x, u, p, t), ex,
                  "Sff", (nx,)),
                 ("cb_g", lambda x, u, t: mm.measurement(x, u, p, t), ex,
                  "Sff", (ny,))]
        if mm.innovation is not None:
            specs.append(("cb_inn", mm.innovation, (z(ny), z(ny)), "ff",
                          (ny,)))
        if mm.mean is not None:
            specs.append(("cb_mean", lambda ys_: mm.mean(ys_, W),
                          (z(nsig, ny),), "f", (ny,)))
        if ukf.state_mean is not None:
            specs.append(("cb_smean", lambda xs_: ukf.state_mean(xs_, W),
                          (z(nsig, nx),), "f", (nx,)))
        progs = _lower_all(specs)
        return None if progs is None else Compiled(
            "UKF", nx, ny, nu, progs, time.perf_counter() - t0,
            layout=ukf_layout(nx))
    return _cached(ukf, ("UKF", nu, str(device)), make)


# ---------------------------------------------------------------------------
# The plain twins
# ---------------------------------------------------------------------------


def _traj_lists():
    return {k: [] for k in _FIELDS}


def _stack(outs) -> tuple:
    return tuple(torch.stack(outs[k]) for k in _FIELDS)


def _ll_term(L, e):
    w = tri_solve(L, e[:, None], lower=True)
    return -0.5 * ((w * w).sum() + 2.0 * torch.log(torch.diagonal(L)).sum()
                   + e.shape[0] * _LOG2PI)


def _gain(L, rhs):
    """``S⁻¹ rhs`` by two triangular solves with L = chol(S)."""
    return tri_solve(L.mT, tri_solve(L, rhs, lower=True), lower=False)


def _riccati(R, A, C, R1, R2, alpha: float, eye):
    """One Riccati update of kernel H from the prior ``R``: ``(S, L, Kᵀ,
    S⁻¹, Rpost, Rn, converged)``, ``converged`` the freeze test on the
    movement from ``R`` to the next prior ``Rn``."""
    CR = C @ R
    S = symmetrize(CR @ C.mT) + R2
    L = chol_lower(S)
    Kt = _gain(L, CR)
    Rpost = symmetrize(R - Kt.mT @ CR)
    Rn = alpha * symmetrize(A @ Rpost @ A.mT) + R1
    conv = bool((Rn - R).abs().max() <= FTOL * (1.0 + Rn.abs().max()))
    return S, L, Kt, _gain(L, eye), Rpost, Rn, conv


def akf_scan_plain(ys, cs, ds, x0, P0, R1, R2, A, C, alpha: float, *,
                   traj: bool = False):
    """Kernel H's recursion as PyTorch ops, freeze included; returns
    ``(ll, (x, R, xt, Rt, e, S, K) or None)``.  A drive given as None is
    zero."""
    T, ny = ys.shape
    At, Ct = A.mT, C.mT
    eye = torch.eye(ny, dtype=ys.dtype, device=ys.device)
    R, x = P0, x0
    ll = ys.new_zeros(())
    conv = False
    outs = _traj_lists() if traj else None
    for t in range(T):
        if not conv:
            Rp = R
            S, L, Kt, Sinv, Rpost, R, conv = _riccati(R, A, C, R1, R2, alpha,
                                                      eye)
            KtAt = Kt @ At
            G = At - Ct @ KtAt
            logdet = 2.0 * torch.log(torch.diagonal(L)).sum()
        yeff = ys[t] if ds is None else ys[t] - ds[t]
        e = yeff - x @ Ct
        q = ((e @ Sinv) * e).sum()
        ll = ll + (-0.5 * (q + logdet + ny * _LOG2PI))
        if traj:
            for k, v in zip(_FIELDS, (x, Rp, x + e @ Kt, Rpost, e, S,
                                      Kt.mT)):
                outs[k].append(v)
        x = x @ G + yeff @ KtAt
        if cs is not None:
            x = x + cs[t]
    return ll, (_stack(outs) if traj else None)


def akf_freeze_step(P0, R1, R2, A, C, alpha: float, T: int) -> int:
    """The first step of kernel H's parallel tail: one past the step
    whose Riccati update met the freeze test, by the twin's arithmetic
    (T when no update within T did).  The steps before it are the serial
    prefix."""
    eye = torch.eye(C.shape[0], dtype=P0.dtype, device=P0.device)
    R = P0
    for t in range(T):
        *_, R, conv = _riccati(R, A, C, R1, R2, alpha, eye)
        if conv:
            return t + 1
    return T


def _gaussian_inputs(f, device):
    """``(x0, P0, R1, R2)`` of filter ``f`` as float32 on ``device``."""
    return [t.to(device=device, dtype=torch.float32).contiguous() for t in (
        f.d0.mean, f.d0.cov, f.R1, f.measurement_model.R2)]


def _step_inputs(us, t, Ts, like):
    u = us[t] if us is not None else like.new_zeros(0)
    return u, torch.tensor(float(t), dtype=torch.float32,
                           device=like.device) * Ts


def ekf_scan_plain(ekf, ys, us=None, *, traj: bool = False):
    """Kernel I's recursion as PyTorch ops: the callbacks and
    ``torch.func.jacfwd`` (or the user's Jacobians) per step."""
    mm, p = ekf.measurement_model, ekf.p
    f, g = ekf.dynamics, mm.measurement
    x, R, R1, R2 = _gaussian_inputs(ekf, ys.device)
    alpha, Ts = float(ekf.alpha), float(ekf.Ts)
    jac = torch.func.jacfwd
    ll = ys.new_zeros(())
    outs = _traj_lists() if traj else None
    for t in range(ys.shape[0]):
        u, tk = _step_inputs(us, t, Ts, ys)
        gx = g(x, u, p, tk)
        Cj = (mm.Cjac(x, u, p, tk) if mm.Cjac is not None
              else jac(lambda xx: g(xx, u, p, tk))(x))
        CR = Cj @ R
        S = symmetrize(CR @ Cj.mT) + R2
        L = chol_lower(S)
        e = ys[t] - gx
        Kt = _gain(L, CR)
        xp, Rp = x, R
        x = x + e @ Kt
        R = symmetrize(R - Kt.mT @ CR)
        ll = ll + _ll_term(L, e)
        if traj:
            for k, v in zip(_FIELDS, (xp, Rp, x, R, e, S, Kt.mT)):
                outs[k].append(v)
        Aj = (ekf.Ajac(x, u, p, tk) if ekf.Ajac is not None
              else jac(lambda xx: f(xx, u, p, tk))(x))
        xn = f(x, u, p, tk)
        R = alpha * symmetrize(Aj @ R @ Aj.mT) + R1
        x = xn
    return ll, (_stack(outs) if traj else None)


def ukf_scan_plain(ukf, ys, us=None, *, traj: bool = False):
    """Kernel G's recursion as PyTorch ops: sigma points by the same
    Cholesky, the callbacks under ``torch.func.vmap``, the UT sums as
    weighted products."""
    mm, p = ukf.measurement_model, ukf.p
    f, g = ukf.dynamics, mm.measurement
    x, R, R1, R2 = _gaussian_inputs(ukf, ys.device)
    nx = x.shape[0]
    W = ukf_weights(ukf.weight_params, nx)
    Ts = float(ukf.Ts)
    wm = torch.full((2 * nx + 1,), W.wmi, dtype=x.dtype, device=x.device)
    wc = torch.full_like(wm, W.wci)
    wm[0], wc[0] = W.wm, W.wc
    vm = torch.func.vmap

    def sigma(x, R):
        dev = chol_lower(symmetrize(W.W * R)).mT
        return torch.cat([x[None], x + dev, x - dev])

    ll = ys.new_zeros(())
    outs = _traj_lists() if traj else None
    for t in range(ys.shape[0]):
        u, tk = _step_inputs(us, t, Ts, ys)
        xs = sigma(x, R)
        ysig = vm(lambda s: g(s, u, p, tk))(xs)
        ym = mm.mean(ysig, W) if mm.mean is not None else wm @ ysig
        dy = ysig - ym
        S = symmetrize((dy * wc[:, None]).mT @ dy) + R2
        Cxy = ((xs - x) * wc[:, None]).mT @ dy
        L = chol_lower(S)
        e = mm.innovation(ys[t], ym) if mm.innovation is not None \
            else ys[t] - ym
        Kt = _gain(L, Cxy.mT)
        xp, Rp = x, R
        x = x + e @ Kt
        R = symmetrize(R - Kt.mT @ S @ Kt)
        ll = ll + _ll_term(L, e)
        if traj:
            for k, v in zip(_FIELDS, (xp, Rp, x, R, e, S, Kt.mT)):
                outs[k].append(v)
        xs = sigma(x, R)
        prop = vm(lambda s: f(s, u, p, tk))(xs)
        xn = ukf.state_mean(prop, W) if ukf.state_mean is not None \
            else wm @ prop
        dp = prop - xn
        R = symmetrize((dp * wc[:, None]).mT @ dp) + R1
        x = xn
    return ll, (_stack(outs) if traj else None)


# ---------------------------------------------------------------------------
# The kernel wrappers
# ---------------------------------------------------------------------------


def _outputs(T, nx, ny, device, traj):
    """``ll [1]`` and, for a trajectory, the seven [T, ...] solution
    tensors with their pointers (nulls without)."""
    ll = torch.empty(1, dtype=torch.float32, device=device)
    if not traj:
        return ll, None, [None] * 7
    shapes = ((T, nx), (T, nx, nx), (T, nx), (T, nx, nx), (T, ny),
              (T, ny, ny), (T, nx, ny))
    outs = tuple(torch.empty(s, dtype=torch.float32, device=device)
                 for s in shapes)
    return ll, outs, [o.data_ptr() for o in outs]


def akf_scan(ys, cs, ds, x0, P0, R1, R2, A, C, alpha: float, *,
             traj: bool = False, stats: Optional[torch.Tensor] = None):
    """Kernel H: the log-likelihood (and the solution when ``traj``) of
    the affine KF over ``ys [T, ny]`` with drives ``cs [T, nx]``, ``ds
    [T, ny]`` (None for a drive that is zero: it is not read).  A CUDA
    ``ys`` launches the kernel; a CPU one runs the twin.  ``stats``, an
    int64 [6] tensor on the card, receives the freeze step t_f (the tail's
    first step, :func:`akf_freeze_step`) and thread 0's ``clock64`` cycles
    in the serial prefix and in the parallel tail, then of the tail in its
    first pass (with G^L), the scan of the chunk ends and its second
    pass."""
    if not ys.is_cuda:
        return akf_scan_plain(ys, cs, ds, x0, P0, R1, R2, A, C, alpha,
                              traj=traj)
    T, ny = ys.shape
    nx = A.shape[0]
    if not (1 <= nx <= MAX_DIM and 1 <= ny <= MAX_DIM):
        raise ValueError(f"akf_scan: nx and ny must be in [1, {MAX_DIM}]")
    for name, t, shape in (("ys", ys, (T, ny)), ("cs", cs, (T, nx)),
                           ("ds", ds, (T, ny)), ("x0", x0, (nx,)),
                           ("P0", P0, (nx, nx)), ("R1", R1, (nx, nx)),
                           ("R2", R2, (ny, ny)), ("A", A, (nx, nx)),
                           ("C", C, (ny, nx))):
        if t is not None:
            require_cuda_f32(name, t, shape)
    ll, outs, ptrs = _outputs(T, nx, ny, ys.device, traj)
    args = (ys.data_ptr(), cs.data_ptr() if cs is not None else None,
            ds.data_ptr() if ds is not None else None, x0.data_ptr(),
            P0.data_ptr(), R1.data_ptr(), R2.data_ptr(), A.data_ptr(),
            C.data_ptr(), float(alpha), T, nx, ny, ll.data_ptr(), *ptrs)
    lib = library().lib
    if stats is None:
        code = lib.llpf_akf_scan(*args, stream_ptr(ys))
    else:
        if not (stats.is_cuda and stats.dtype == torch.int64
                and stats.numel() == 6 and stats.is_contiguous()):
            raise ValueError("akf_scan: stats must be a contiguous int64 "
                             "[6] CUDA tensor")
        code = lib.llpf_akf_scan_stats(*args, stats.data_ptr(),
                                       stream_ptr(ys))
    check(code, "akf_scan")
    AKF_SCAN.launches += 1
    return ll[0], outs


def _generated_inputs(f, comp, ys, us):
    T = ys.shape[0]
    require_cuda_f32("ys", ys, (T, comp.ny))
    if comp.nu:
        require_cuda_f32("us", us, (T, comp.nu))
    gauss = _gaussian_inputs(f, ys.device)
    for name, t in zip(("x0", "P0", "R1", "R2"), gauss):
        require_cuda_f32(name, t)
    return gauss, comp.consts(ys.device), (us.data_ptr() if comp.nu
                                           else None)


def _nu(us) -> int:
    return 0 if us is None else us.shape[-1]


def ekf_scan(ekf, ys, us=None, *, traj: bool = False):
    """Kernel I over ``ys [T, ny]`` (``us [T, nu]``): ``(ll, solution
    fields or None)``.  A CUDA ``ys`` launches the filter's generated
    kernel (built at first use); a CPU one runs the twin."""
    if not ys.is_cuda:
        return ekf_scan_plain(ekf, ys, us, traj=traj)
    comp = _ekf_programs(ekf, _nu(us), ys.device)
    if comp is None:
        raise ValueError("kernel I does not admit this filter's callbacks")
    lib = comp.library()
    (x0, P0, R1, R2), c, us_ptr = _generated_inputs(ekf, comp, ys, us)
    T = ys.shape[0]
    ll, outs, ptrs = _outputs(T, comp.nx, comp.ny, ys.device, traj)
    check(lib.llpf_ekf_scan(
        ys.data_ptr(), us_ptr, x0.data_ptr(), P0.data_ptr(), R1.data_ptr(),
        R2.data_ptr(), c.data_ptr(), float(ekf.alpha), float(ekf.Ts), T,
        ll.data_ptr(), *ptrs, stream_ptr(ys)), "ekf_scan")
    EKF_SCAN.launches += 1
    return ll[0], outs


def ukf_scan(ukf, ys, us=None, *, traj: bool = False):
    """Kernel G over ``ys [T, ny]`` (``us [T, nu]``), as :func:`ekf_scan`."""
    if not ys.is_cuda:
        return ukf_scan_plain(ukf, ys, us, traj=traj)
    comp = _ukf_programs(ukf, _nu(us), ys.device)
    if comp is None:
        raise ValueError("kernel G does not admit this filter's callbacks")
    lib = comp.library()
    (x0, P0, R1, R2), c, us_ptr = _generated_inputs(ukf, comp, ys, us)
    W = ukf_weights(ukf.weight_params, comp.nx)
    T = ys.shape[0]
    ll, outs, ptrs = _outputs(T, comp.nx, comp.ny, ys.device, traj)
    check(lib.llpf_ukf_scan(
        ys.data_ptr(), us_ptr, x0.data_ptr(), P0.data_ptr(), R1.data_ptr(),
        R2.data_ptr(), c.data_ptr(), W.wm, W.wmi, W.wc, W.wci, W.W,
        float(ukf.Ts), T, ll.data_ptr(), *ptrs, stream_ptr(ys)), "ukf_scan")
    UKF_SCAN.launches += 1
    return ll[0], outs


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def _solution(f, us, ys, ll, outs, route) -> KalmanFilteringSolution:
    """The per-step [T, ...] outputs as a filtering solution (the
    sequential solution's field conventions)."""
    from ..trajectory import _as_u_seq

    x, R, xt, Rt, e, S, K = outs
    T = ys.shape[0]
    ok = torch.isfinite(xt).all(-1) & torch.isfinite(e).all(-1)
    return KalmanFilteringSolution(
        u=_as_u_seq(us, T, ys.dtype, ys.device), y=ys, x=x, xt=xt, R=R,
        Rt=Rt, ll=ll, e=e, K=K, S=S, extra=None,
        t=torch.arange(T, dtype=ys.dtype, device=ys.device) * f.Ts, ok=ok,
        route=route)


def _sequential(f, us, ys, want_traj):
    from ..trajectory import forward_trajectory, loglik

    if want_traj:
        return forward_trajectory(f, us, ys, method="sequential")
    return loglik(f, us, ys, method="sequential")


def _data_ok(f, ys, us) -> bool:
    from ..routing import _needs_grad, _under_batch_trace

    return (_f32(ys, us) and (us is None or us.ndim == 2)
            and not _under_batch_trace(f, ys, us)
            and not _needs_grad(f, ys, us))


def _finish(f, us, ys, ll, outs, want_traj):
    from ..routing import _record

    route = "cuda_fused_scan" if ys.is_cuda else "fused_scan_plain"
    _record("forward_trajectory" if want_traj else "loglik", route)
    return _solution(f, us, ys, ll, outs, route) if want_traj else ll


def _contiguous(ys, us):
    return ys.contiguous(), (us.contiguous() if us is not None
                             and us.shape[-1] else None)


def _run_h_or_i(v: Affinity, ys, us, want_traj: bool):
    """Kernel H (constant Jacobians) or I on the verdict's EKF; None when
    kernel I does not admit its callbacks."""
    ekf = v.ekf
    if v.AC is not None:
        cs, ds = live_drives(*drives(ekf, us, ys.shape[0], ys.device))
        x0, P0, R1, R2 = _gaussian_inputs(ekf, ys.device)
        A, C = (M.to(ys.device) for M in v.AC)
        ll, outs = akf_scan(ys, cs, ds, x0, P0, R1, R2, A, C,
                            float(ekf.alpha), traj=want_traj)
    else:
        if _ekf_programs(ekf, _nu(us), ys.device) is None:
            return None
        ll, outs = ekf_scan(ekf, ys, us, traj=want_traj)
    return _finish(ekf, us, ys, ll, outs, want_traj)


def _ekf_fused(f, ys, us, *, want_traj: bool, allow_cpu: bool):
    """Kernel H or I for an admitted EKF, or a ``KalmanFilter`` through
    its delegate, on CUDA tensors (their twins on the CPU when
    ``allow_cpu``); None when the sequential recursion should run."""
    if not (ys.is_cuda or allow_cpu) or not _data_ok(f, ys, us):
        return None
    ys, us = _contiguous(ys, us)
    v = affinity(f, _nu(us))
    return None if v.ekf is None else _run_h_or_i(v, ys, us, want_traj)


def _ukf_fused(ukf, ys, us, *, want_traj: bool, allow_cpu: bool,
               pin_g: bool):
    """Kernel G for an admitted UKF, or kernel H/I through the equivalent
    EKF of an affine one (unless ``pin_g``); None for sequential."""
    mm = ukf.measurement_model
    if (not _supported(ukf, mm) or not (ys.is_cuda or allow_cpu)
            or not _data_ok(ukf, ys, us)):
        return None
    ys, us = _contiguous(ys, us)
    if not pin_g:
        # the unscented transform is exact for affine callbacks, so the
        # UKF recursion is the EKF's (the JAX package's affine fast path)
        v = affinity(ukf, _nu(us))
        if v.ekf is not None:
            return _run_h_or_i(v, ys, us, want_traj)
    if _ukf_programs(ukf, _nu(us), ys.device) is None:
        return None
    ll, outs = ukf_scan(ukf, ys, us, traj=want_traj)
    return _finish(ukf, us, ys, ll, outs, want_traj)


def ukf_loglik_fused(ukf, ys, us=None, force_kernel: bool = False,
                     _want_traj: bool = False):
    """Total log-likelihood of ``ys`` under ``ukf`` in one kernel launch:
    G, or H/I for an affine model (``force_kernel=True`` pins G).  On CPU
    tensors only ``force_kernel`` runs a kernel — its plain twin;
    otherwise, and out of scope, the sequential recursion runs.
    ``last_route()`` names the path."""
    out = _ukf_fused(ukf, ys, us, want_traj=_want_traj,
                     allow_cpu=force_kernel, pin_g=force_kernel)
    return out if out is not None else _sequential(ukf, us, ys, _want_traj)


def ukf_forward_trajectory_fused(ukf, us, ys, force_kernel: bool = False):
    """The full filtering solution from the same kernels."""
    return ukf_loglik_fused(ukf, ys, us, force_kernel, _want_traj=True)


def ekf_loglik_fused(ekf, ys, us=None, force_kernel: bool = False,
                     _want_traj: bool = False):
    """EKF counterpart of :func:`ukf_loglik_fused`: kernel H when the
    Jacobians are constant, else kernel I.  ``ekf`` may also be a
    ``KalmanFilter``, which runs as its delegate EKF."""
    out = _ekf_fused(ekf, ys, us, want_traj=_want_traj,
                     allow_cpu=force_kernel)
    return out if out is not None else _sequential(ekf, us, ys, _want_traj)


def ekf_forward_trajectory_fused(ekf, us, ys, force_kernel: bool = False):
    """The full filtering solution from the same kernels."""
    return ekf_loglik_fused(ekf, ys, us, force_kernel, _want_traj=True)
