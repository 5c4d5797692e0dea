#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

    python3 chip_smoke.py

Phases (each prints a line; the first that fails raises, and the script
exits non-zero without its result lines):

1. device: the card, its power limit, the CUDA toolkit; TF32 off.
2. build: the kernels of ``lowlevelparticlefilters_jl_tpu_torch/csrc``.
3. each kernel against its plain PyTorch twin on the card, at the main
   path's shapes, with its tolerance and the reason for it; times both.
4. main path: the benchmark's 2-state model (bench.py:389-402) at
   N = 1e5, T = 1000, Neff threshold 0.1, through ``pf.loglik`` on CUDA
   tensors: kernel A, PF ll within 1 % of the exact KF ll; median time of
   5 calls.  Then N = 1e6, T = 200 with the same check.
5. unfused path: ``pf.forward_trajectory`` at N = 1e5, T = 100 with
   ``noise_backend="kernel"`` (kernels B, C, D), within 1 % of the KF;
   a second seeded call bitwise equal to the first.
6. the KF bank, ``kf_bank_loglik`` on the benchmark's bank model
   (bench.py:423-469): kernel F against its twin at B = 1024, T = 200;
   the route and one launch each of kernels K and F per call at B = 1024
   and B = 8192; ll against a float64 CPU oracle; median time of 5.
7. the temporal-parallel KF (bench.py:724-736): kernel K's filter and
   smooth scans against their twin at T = 1e5; ``loglik``,
   ``forward_trajectory`` and ``parallel_rts_smooth`` on CUDA tensors
   against float64 CPU references at T = 2000, 1e5 and 1e6; median time
   of 5 ``loglik`` calls at T = 1e5.
8. kernel H on the 4-state CV model (bench.py:472-490), T = 5e4:
   ``kf.loglik_fused``, ``loglik(kf, method="fused")``,
   ``kf.forward_trajectory_fused`` and the affine CV UKF's
   ``ukf_loglik_fused`` (H, not G); H against its twin at T = 2000 and
   the ll against the float64 CPU sequential KF at T = 5000.
9. kernel I on ``A x + 0.01 sin x`` (tests/test_ukf_fused.py:88-98),
   T = 5e4: ``loglik`` under "auto", ``forward_trajectory`` with
   ``method="fused"``, and a case with user Jacobians; I against its twin
   at T = 2000, the ll against float64 CPU sequential at T = 5000.
10. kernel G on the quadtank model (bench.py:695-712) under "auto" and
   the CV UKF with ``force_kernel=True``, T = 5e4, and an angle-wrap
   innovation hook (bench.py:211-233); G against its twin at T = 2000,
   the ll against float64 CPU sequential at T = 5000.
   Phases 8-10 print the median of 5 calls, the kernel's CUDA-event time,
   the launches per call and the seconds of tracing and of the callback
   library's build, apart from the calls.
11. FFBS on the bench_ffbs model (bench.py:548-564): ``pf.smooth`` with
   M = 1000 at N = 1000, T = 500 and at N = 65536, T = 24 (forward pass
   through B, C, D; one launch of kernel J a call); the smoothed mean
   within ``FFBS_RMS_Z`` RTS deviations of the float64 exact smoother; J
   against its twin on a fixed forward solution, MAP columns equal and
   the Philox draws within 0.1 %; J's CUDA-event time, median of 5 calls.
12. the RTS family: ``smooth`` of the KF at T = 1e5
   (``parallel_rts_smooth``), of the CV UKF, the quadtank UKF and the
   ``A x + 0.01 sin x`` EKF at T = 5e4 (the iterated parallel smoothers on
   kernel K), ``parallel_ukf_smooth(iters=4)`` as bench.py:695-721 and
   the quadtank ``smooth(fused=True)`` (one launch of G) at T = 2000; each
   against float64 CPU runs of the same function (T = 1e5, 5000, 2000),
   with ``method="sequential"`` and ``smooth_mbf``; medians of 5.

13. PF state tracking on the benchmark's model at N = 1e5, T = 1000:
   ``mean_trajectory(pf, u, y, generator=g)`` and ``pf_stats_fused`` (one
   launch each of kernel A's moments mode), ``pf_segment_fused`` at
   T = 100 (segment mode) and ``pf.loglik`` with a
   ``TupleProduct(StudentT, Laplace)`` measurement density (A's
   scalar-density weights); the means within ``TRACK_Z`` KF deviations
   (RMS) of the float64 x(t|t), the variances within ``TRACK_VAR`` (RMS,
   relative) of P(t|t); ``ll_local + lse(w_fin)`` of the segment equal to
   the loglik mode's ll; the scalar-density ll within 1 % of the mean of
   3 sequential-route runs; each mode against its twin at T = 200 (no
   noise, the same Philox stream, the lattice case); medians of 5.
14. kernel E against its twin at N = 1e5, nx = 2 and 8, random, U^20 and
   single-particle weights, bitwise; ``pf.forward_trajectory`` with
   ``exact_resample=True`` at N = 1e5, T = 100: one E launch a resample,
   ll within 1 % of the KF, bitwise equal to the kernel-B run.
15. ``AuxiliaryParticleFilter`` ``forward_trajectory`` at N = 1e5,
   T = 1000 (the APF never scores y[0], about 1 % of |ll| at T = 100) and
   ``AdvancedParticleFilter.loglik`` at T = 100, each with kernel B and
   with E (``exact_resample``), bitwise equal, ll within 1 % of the KF.

Launch counts are reset just before each path's run (phases 4-5, 6, 7,
8, 9, 10, 11, 12, 13, 14 and 15) and read just after it; every kernel of
the path must have launched there.  The kernels line (with each kernel's bound: the larger of its
bytes over 3.35 TB/s and its operations over 67 T/s) and the card's
``nvidia-smi`` line come before the last line,
``{"ok": true, "device": {...}}``.  Imports no JAX.
"""
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
N_MAIN, T_MAIN, THRESH = 100_000, 1000, 0.1
T_BANK, T_PAR = 200, 100_000
T_SCAN, T_TWIN, T_REF = 50_000, 2_000, 5_000  # phases 8-10
CV_A = [[1, 0, 0.1, 0], [0, 1, 0, 0.1], [0, 0, 1, 0], [0, 0, 0, 1]]
CV_C = [[1, 0, 0, 0], [0, 1, 0, 0]]
HBM_BYTES_PER_S, PEAK_OPS_PER_S = 3.35e12, 67e12  # one H100 SXM, 700 W
# arithmetic model of the noise kernels: one Philox4x32-10 call (4 words)
# is ~100 integer operations, one Box-Muller normal ~20 (special
# functions counted as one operation each)
PHILOX_OPS, NORMAL_OPS = 100, 20


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def require(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, reps):
    """Mean ms per call of ``fn`` on the card (CUDA events), after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def bound(nbytes, ops):
    """Least time for the work: bytes over the memory rate or operations
    over the f32 peak, whichever is larger."""
    tb, to = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S
    return dict(bound_ms=max(tb, to) * 1e3,
                bound_by="bytes" if tb >= to else "operations")


def host_median_ms(fn, reps=5):
    """Median host time of ``fn`` with a synchronize, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


class _Count:
    """A scalar that counts the arithmetic done on it, to count the
    operations of one scan combine from its formula."""

    n = 0

    def _op(self, other):
        _Count.n += 1
        return self

    def __radd__(self, other):
        return self if isinstance(other, int) and other == 0 else self._op(
            other)

    __add__ = __sub__ = __rsub__ = __mul__ = __rmul__ = _op
    __truediv__ = __rtruediv__ = _op


def combine_ops(combine, shape):
    """Operations of one combine of elements with ``shape`` (a tuple of
    ('m', n) / ('v', n) parts)."""
    def elem():
        return tuple(tuple(tuple(_Count() for _ in range(n))
                           for _ in range(n)) if k == "m"
                     else tuple(_Count() for _ in range(n))
                     for k, n in shape)
    _Count.n = 0
    combine(elem(), elem())
    return _Count.n


def scan_combines(n, chunk=16):
    """Combines kernel K does for n elements: per level, each chunk's
    reduction and the in-chunk scan with its prefix, csrc/assoc_scan.cu."""
    if n <= chunk:
        return n - 1
    nch = -(-n // chunk)
    return (n - nch) + scan_combines(nch, chunk) + (n - 1)


def register_table(log):
    """(kernel, registers, spill bytes) from the ptxas lines of the
    build log, with the scan kernels' template arguments spelled out."""
    rows, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"\d+([a-z][a-z_]*_kernel)(?:INS_\d+(\w+?Op)"
                          r"ILi(\d)E+(?:Lb(\d)E+)?)?", m.group(1))
            name = m.group(1) if k is None else (
                k.group(1) + (f"<{k.group(2)}<{k.group(3)}>"
                              + (f",{k.group(4)}" if k.group(4) else "")
                              + ">" if k.group(2) else ""))
            spill = 0
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, int(m.group(1)), spill))
            name = None
    return rows


def check_twin(what, got, want, fields):
    """A whole-scan kernel against its twin: ll within 1e-5 relative, the
    solution within rtol 2e-4, atol 1e-5 (the JAX tests' trajectory
    bounds, tests/test_ukf_fused.py:139); the largest absolute
    difference."""
    (llg, og), (llw, ow) = got, want
    llg, llw = float(llg), float(llw)
    require(abs(llg - llw) <= 1e-5 * abs(llw),
            f"{what}: ll {llg} within 1e-5 of the twin's {llw}")
    err = abs(llg - llw)
    for name, a, b in zip(fields, og or (), ow or ()):
        require(torch.allclose(a, b, rtol=2e-4, atol=1e-5),
                f"{what}: {name} within rtol 2e-4, atol 1e-5 of the twin")
        err = max(err, float((a - b).abs().max()))
    return err


def check_ref(what, ll, ref, tol=1e-4):
    rel = abs(float(ll) - ref) / abs(ref)
    require(rel < tol, f"{what}: ll {float(ll)} within {tol} of the float64 "
            f"CPU sequential {ref} (got {rel:.3g})")
    return rel


def per_step_ops_ekf(nx, ny, n_f, n_g, dual):
    """Operations of one EKF step (csrc/ukf_scan.cuh): the callbacks (a
    dual-number instruction costs nx + 1), the gain, the updates."""
    cb = (n_f + n_g) * ((nx + 1) if dual else 1)
    return (cb + 2 * ny * nx * nx + 2 * ny * ny * nx + 3 * ny * ny + ny ** 3
            + 4 * ny * ny * nx + 2 * nx * ny + 2 * nx * nx * ny
            + 3 * nx * nx + ny * ny + 3 * ny + 4 + 6 * nx ** 3
            + 3 * nx * nx)


def per_step_ops_ukf(nx, ny, n_f, n_g):
    """Operations of one UKF step, each counted once (the lanes of the
    warp repeat the shared algebra): two factorizations and sigma sets,
    the callbacks on 2nx + 1 points, the UT sums, the gain, the updates."""
    ns = 2 * nx + 1
    return (2 * (nx ** 3 + 2 * nx * nx + ns * nx) + ns * (n_f + n_g)
            + 2 * ns * ny + 3 * ns * ny * ny + 3 * ns * nx * ny + ny ** 3
            + 4 * ny * ny * nx + 2 * nx * ny + 2 * nx * ny * ny
            + 2 * nx * nx * ny + 3 * nx * nx + ny * ny + 3 * ny + 4
            + 2 * ns * nx + 3 * ns * nx * nx + 2 * nx * nx)


def riccati_steps(A, C, R1, R2, P0, alpha, ftol):
    """Steps kernel H runs the Riccati update before it freezes (its
    criterion, float32 on the host): the data-dependent part of its
    work."""
    from lowlevelparticlefilters_jl_tpu_torch.ops.linalg import (
        chol_lower, symmetrize, tri_solve)

    R, n = P0.cpu(), 0
    A, C, R1, R2 = (M.cpu() for M in (A, C, R1, R2))
    while n < 100_000:
        n += 1
        CR = C @ R
        L = chol_lower(symmetrize(CR @ C.T) + R2)
        Kt = tri_solve(L.T, tri_solve(L, CR), lower=False)
        Rn = alpha * symmetrize(A @ symmetrize(R - Kt.T @ CR) @ A.T) + R1
        if float((Rn - R).abs().max()) <= ftol * (1 + float(Rn.abs().max())):
            return n
        R = Rn
    return n


def nvidia_smi_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def _eye(n, s, dt, d):
    return s * torch.eye(n, dtype=dt, device=d)


def nonlinear_ekf(d, dt, user_jac=False):
    """``A x + 0.01 sin x`` on the CV model (tests/test_ukf_fused.py:88-98),
    with the exact Jacobians as user callbacks when ``user_jac``."""
    import lowlevelparticlefilters_jl_tpu_torch as llpt

    A_ = torch.tensor(CV_A, dtype=dt, device=d)
    C_ = torch.tensor(CV_C, dtype=dt, device=d)
    jac = dict(Ajac=lambda x, u, p, t: A_ + 0.01 * torch.diag(
        torch.cos(x)), Cjac=lambda x, u, p, t: C_) if user_jac else {}
    return llpt.make_ekf(
        lambda x, u, p, t: A_ @ x + 0.01 * torch.sin(x),
        lambda x, u, p, t: C_ @ x, _eye(4, 0.1, dt, d), _eye(2, 1, dt, d),
        d0=llpt.MvNormal(torch.zeros(4, dtype=dt, device=d),
                         _eye(4, 0.5, dt, d)), nu=0, ny=2, **jac)


def quadtank_ukf(d, dt):
    """The quadtank UKF (bench.py:695-712)."""
    import lowlevelparticlefilters_jl_tpu_torch as llpt

    g1 = lambda x: torch.sqrt(torch.abs(x) + 0.1)  # noqa: E731

    def dyn(x, u, p, t):
        return x + 0.1 * torch.stack([-g1(x[0]) + 0.5 * g1(x[1]),
                                      -0.5 * g1(x[1]) + 0.1])

    return llpt.make_ukf(
        dyn, lambda x, u, p, t: x, _eye(2, 1e-3, dt, d),
        _eye(2, 1e-2, dt, d), ny=2, nu=0,
        d0=llpt.MvNormal(torch.ones(2, dtype=dt, device=d),
                         _eye(2, 0.1, dt, d)))


def cv_ukf(d, dt):
    """The affine CV UKF (bench.py:665-681)."""
    import lowlevelparticlefilters_jl_tpu_torch as llpt

    A_ = torch.tensor(CV_A, dtype=dt, device=d)
    C_ = torch.tensor(CV_C, dtype=dt, device=d)
    return llpt.make_ukf(lambda x, u, p, t: A_ @ x, lambda x, u, p, t: C_ @ x,
                         _eye(4, 0.1, dt, d), _eye(2, 1.0, dt, d), ny=2, nu=0)


def whole_scan_phases(dev, kernels, stats, launches, smi):
    """Phases 8-10: the whole-scan kernels H, I and G on their main paths
    (see the module doc); fills ``stats`` and ``launches``."""
    import lowlevelparticlefilters_jl_tpu_torch as llpt
    from lowlevelparticlefilters_jl_tpu_torch import convert
    from lowlevelparticlefilters_jl_tpu_torch.kernels import _lib, ukf_scan

    FIELDS = ukf_scan._FIELDS
    AKF, EKF, UKF = ukf_scan.AKF_SCAN, ukf_scan.EKF_SCAN, ukf_scan.UKF_SCAN
    eye = lambda n, s=1.0, dt=torch.float32, d=dev: s * torch.eye(  # noqa
        n, dtype=dt, device=d)
    mat = lambda M, dt=torch.float32, d=dev: torch.tensor(  # noqa: E731
        M, dtype=dt, device=d)

    def randn(T, ny, seed, scale=1.0, shift=0.0):
        g = torch.Generator().manual_seed(seed)
        return shift + scale * torch.randn(T, ny, generator=g)

    def solution(sol):
        return sol.ll, tuple(getattr(sol, f) for f in FIELDS)

    def report(tag, kinfo, call, trace_s, build_s):
        """Median of 5 host-clock calls after a warm-up, launches a call."""
        k0 = kinfo.launches
        med = host_median_ms(call)
        per = (kinfo.launches - k0) / 6
        log(tag, f"median of 5: {med:.3f} ms, {T_SCAN / med * 1e3:.4g} "
            f"steps/s; {per:g} launch(es) of {kinfo.name} a call; tracing "
            f"{trace_s} s, callback build {build_s} s, apart from the "
            f"calls ({smi})")

    def prepare(comp):
        """Trace (already done, timed by _cached) and build a filter's
        callback library, apart from its first call."""
        t0, nb = time.perf_counter(), len(_lib.GEN_BUILDS)
        comp.library()
        dt = time.perf_counter() - t0
        for name, regs, spill in register_table(
                _lib.GEN_BUILDS[0][1] if len(_lib.GEN_BUILDS) > nb else ""):
            log("build", f"{comp.kind} {name}: {regs} registers, {spill} "
                "bytes spilled")
        return round(comp.trace_seconds, 3), round(dt, 3)

    # ---- 8. kernel H ----------------------------------------------------------
    kf8 = convert.kalman_filter_from_numpy(CV_A, None, CV_C, 0,
                                           0.1 * np.eye(4), np.eye(2),
                                           dtype=torch.float32, device=dev)
    kf8_64 = convert.kalman_filter_from_numpy(CV_A, None, CV_C, 0,
                                              0.1 * np.eye(4), np.eye(2),
                                              device="cpu")
    ys8 = randn(T_SCAN, 2, 80)
    y8 = ys8.to(dev)
    A8, C8 = mat(CV_A), mat(CV_C)
    ukf8 = llpt.make_ukf(lambda x, u, p, t: A8 @ x, lambda x, u, p, t: C8 @ x,
                         kf8.R1, kf8.R2, ny=2, nu=0)
    for k in kernels:
        k.launches = 0
    ll8 = float(kf8.loglik_fused(y8))
    require(llpt.last_route() == "cuda_fused_scan" and AKF.launches == 1,
            f"kf.loglik_fused: route {llpt.last_route()}, {AKF.launches} H")
    ll8b = float(llpt.loglik(kf8, None, y8, method="fused"))
    require(llpt.last_route() == "cuda_fused_scan" and ll8b == ll8,
            "loglik(kf, method='fused') takes H")
    sol8 = kf8.forward_trajectory_fused(None, y8)
    require(sol8.route == "cuda_fused_scan" and bool(sol8.ok.all())
            and sol8.xt.shape == (T_SCAN, 4), "kf.forward_trajectory_fused")
    llu8 = float(llpt.ukf_loglik_fused(ukf8, y8))
    path8 = {k.name: k.launches for k in kernels}
    require(path8["akf_scan"] == 4 and sum(path8.values()) == 4,
            f"the affine UKF takes H and not G: launches {path8}")
    require(abs(llu8 - ll8) <= 1e-6 * abs(ll8), f"affine UKF ll {llu8} = "
            f"KF ll {ll8}")
    launches["akf_scan"] = path8["akf_scan"]
    v8 = ukf_scan.affinity(kf8, 0)  # the verdict kf8's calls reached
    ekf8, (A8k, C8k) = v8.ekf, v8.AC

    def akf_inputs(T):
        cs, ds = ukf_scan.live_drives(*ukf_scan.drives(ekf8, None, T, dev))
        return (y8[:T].contiguous(), cs, ds,
                *ukf_scan._gaussian_inputs(ekf8, dev), A8k, C8k, 1.0)

    a2k, a50 = akf_inputs(T_TWIN), akf_inputs(T_SCAN)
    # the x = 0 drives of x' = A x, y = C x are zero: H reads ys alone
    drives_read = sum(t.numel() for t in a50[1:3] if t is not None)
    require(drives_read == 0, f"CV KF: zero drives not read ({drives_read})")
    err8 = max(check_twin("H", ukf_scan.akf_scan(*a2k),
                          ukf_scan.akf_scan_plain(*a2k), FIELDS),
               check_twin("H solution", ukf_scan.akf_scan(*a2k, traj=True),
                          ukf_scan.akf_scan_plain(*a2k, traj=True), FIELDS),
               check_twin("forward_trajectory_fused", solution(
                   kf8.forward_trajectory_fused(None, y8[:T_TWIN])),
                   ukf_scan.akf_scan_plain(*a2k, traj=True), FIELDS))
    ref8 = float(llpt.loglik(kf8_64, None, ys8[:T_REF].double(),
                             method="sequential"))
    rel8 = check_ref("H T=5000", kf8.loglik_fused(y8[:T_REF]), ref8)
    n_ric = riccati_steps(A8k, C8k, kf8.R1, kf8.R2, kf8.d0.cov, 1.0,
                          ukf_scan.FTOL)
    ops8 = T_SCAN * 86 + n_ric * 900  # nx = 4, ny = 2 (see PERF.md)
    stats["akf_scan"] = dict(
        max_abs_err=err8, T=T_SCAN, plain_T=T_TWIN, library_ms=None,
        ms=cuda_ms(lambda: ukf_scan.akf_scan(*a50), 20),
        plain_ms=cuda_ms(lambda: ukf_scan.akf_scan_plain(*a2k), 1),
        # ys and the drives it reads; x0, P0, R1, R2, A, C; ll
        **bound(4 * (T_SCAN * 2 + drives_read + 65), ops8))
    log("H akf_scan", f"T={T_SCAN}: ll {ll8} (loglik_fused, method='fused' "
        f"and the affine UKF agree); T={T_REF} rel {rel8:.3g} vs f64 "
        f"sequential; Riccati frozen after {n_ric} steps; launches {path8}; "
        f"{stats['akf_scan']}")
    report("H", AKF, lambda: kf8.loglik_fused(y8), "none", "none (main "
           "library)")

    # ---- 9. kernel I ----------------------------------------------------------
    nl_ekf = nonlinear_ekf
    e9, e9j = nl_ekf(dev, torch.float32), nl_ekf(dev, torch.float32, True)
    ys9 = randn(T_SCAN, 2, 90)
    y9 = ys9.to(dev)
    ts9 = prepare(ukf_scan._ekf_programs(e9, 0, dev))
    ts9j = prepare(ukf_scan._ekf_programs(e9j, 0, dev))
    for k in kernels:
        k.launches = 0
    ll9 = float(llpt.loglik(e9, None, y9))
    require(llpt.last_route() == "cuda_fused_scan" and EKF.launches == 1,
            f"nonlinear EKF auto: route {llpt.last_route()}")
    sol9 = llpt.forward_trajectory(e9, None, y9, method="fused")
    require(sol9.route == "cuda_fused_scan" and bool(sol9.ok.all())
            and abs(float(sol9.ll) - ll9) <= 1e-6 * abs(ll9),
            "forward_trajectory(ekf, method='fused')")
    ll9j = float(llpt.loglik(e9j, None, y9))
    path9 = {k.name: k.launches for k in kernels}
    require(path9["ekf_scan"] == 3 and sum(path9.values()) == 3,
            f"EKF path launches {path9}")
    require(abs(ll9j - ll9) <= 1e-4 * abs(ll9), f"user Jacobians: ll {ll9j} "
            f"vs forward mode {ll9}")
    launches["ekf_scan"] = path9["ekf_scan"]
    y9t = y9[:T_TWIN].contiguous()
    err9 = max(check_twin(f"I{tag}", ukf_scan.ekf_scan(f, y9t, traj=tr),
                          ukf_scan.ekf_scan_plain(f, y9t, traj=tr), FIELDS)
               for f, tag in ((e9, ""), (e9j, " user Jacobians"))
               for tr in (False, True))
    # float64 CPU references, with the exact Jacobians (the same filter,
    # five times faster than forward mode on the CPU): at T = 5000 and at
    # the main path's T, since I's ll at 5e4 has no other kernel to meet
    e9_64 = nl_ekf("cpu", torch.float64, True)
    ref9 = float(llpt.loglik(e9_64, None, ys9[:T_REF].double(),
                             method="sequential"))
    rel9 = check_ref("I T=5000", llpt.loglik(e9, None, y9[:T_REF]), ref9)
    ref9m = float(llpt.loglik(e9_64, None, ys9.double(), method="sequential"))
    rel9m = check_ref(f"I T={T_SCAN}", ll9, ref9m)
    comp9 = ukf_scan._ekf_programs(e9, 0, dev)
    n_f, n_g = (len(p.instrs) for _, p in comp9.progs[:2])
    stats["ekf_scan"] = dict(
        max_abs_err=err9, T=T_SCAN, plain_T=T_TWIN, library_ms=None,
        ms=cuda_ms(lambda: ukf_scan.ekf_scan(e9, y9), 5),
        plain_ms=cuda_ms(lambda: ukf_scan.ekf_scan_plain(e9, y9t), 1),
        # ys, x0, P0, R1, R2, the callbacks' constants, ll
        **bound(4 * (T_SCAN * 2 + 4 + 16 + 16 + 4 + 1 + sum(
            p.n_consts for _, p in comp9.progs)),
            T_SCAN * per_step_ops_ekf(4, 2, n_f, n_g, True)))
    log("I ekf_scan", f"T={T_SCAN}: ll {ll9}, user Jacobians {ll9j}, rel "
        f"{rel9m:.3g} vs f64 sequential; T={T_REF} rel {rel9:.3g}; "
        f"launches {path9}; "
        f"{stats['ekf_scan']}")
    report("I", EKF, lambda: llpt.loglik(e9, None, y9), *ts9)
    log("I", f"user-Jacobian filter: tracing {ts9j[0]} s, build {ts9j[1]} s")

    # ---- 10. kernel G ---------------------------------------------------------
    def angle_ukf(d, dt):
        wrap = lambda a: torch.remainder(a + math.pi, 2 * math.pi) - math.pi

        mm = llpt.UKFMeasurementModel(
            measurement=lambda x, u, p, t: x[:1], R2=eye(1, 0.05, dt, d),
            ny=1, innovation=lambda y_, yh: wrap(y_ - yh))
        return llpt.UnscentedKalmanFilter(
            dynamics=lambda x, u, p, t: torch.stack(
                [wrap(x[0] + 0.1 * x[1]), 0.98 * x[1]]),
            measurement_model=mm,
            R1=torch.diag(torch.tensor([0.01, 0.001], dtype=dt, device=d)),
            nu=0)

    q10 = quadtank_ukf(dev, torch.float32)
    ang10 = angle_ukf(dev, torch.float32)
    ys10 = randn(T_SCAN, 2, 100, scale=0.1, shift=1.0)
    y10 = ys10.to(dev)
    angs = torch.cumsum(0.12 * torch.ones(4096, dtype=torch.float64), 0) - 2
    ya = (torch.remainder(angs + math.pi, 2 * math.pi) - math.pi)[:, None] \
        + 0.1 * randn(4096, 1, 101).double()
    ts10 = prepare(ukf_scan._ukf_programs(q10, 0, dev))
    ts10cv = prepare(ukf_scan._ukf_programs(ukf8, 0, dev))
    ts10a = prepare(ukf_scan._ukf_programs(ang10, 0, dev))
    for k in kernels:
        k.launches = 0
    ll10 = float(llpt.loglik(q10, None, y10))
    require(llpt.last_route() == "cuda_fused_scan" and UKF.launches == 1,
            f"quadtank UKF auto: route {llpt.last_route()}")
    ll10cv = float(llpt.ukf_loglik_fused(ukf8, y8, force_kernel=True))
    ll10a = float(llpt.loglik(ang10, None, ya.float().to(dev)))
    path10 = {k.name: k.launches for k in kernels}
    require(path10["ukf_scan"] == 3 and sum(path10.values()) == 3,
            f"UKF path launches {path10}")
    require(abs(ll10cv - ll8) <= 1e-4 * abs(ll8), f"CV UKF through G "
            f"{ll10cv} vs H {ll8}")
    launches["ukf_scan"] = path10["ukf_scan"]
    y10t = y10[:T_TWIN].contiguous()
    yat = ya[:T_TWIN].float().to(dev)
    err10 = max(
        check_twin("G quadtank", ukf_scan.ukf_scan(q10, y10t, traj=True),
                   ukf_scan.ukf_scan_plain(q10, y10t, traj=True), FIELDS),
        check_twin("G quadtank ll", ukf_scan.ukf_scan(q10, y10t),
                   ukf_scan.ukf_scan_plain(q10, y10t), FIELDS),
        check_twin("G CV", ukf_scan.ukf_scan(ukf8, y8[:T_TWIN].contiguous()),
                   ukf_scan.ukf_scan_plain(ukf8, y8[:T_TWIN].contiguous()),
                   FIELDS),
        check_twin("G angle hook", ukf_scan.ukf_scan(ang10, yat),
                   ukf_scan.ukf_scan_plain(ang10, yat), FIELDS))
    ref10 = float(llpt.loglik(quadtank_ukf("cpu", torch.float64), None,
                              ys10[:T_REF].double(), method="sequential"))
    rel10 = check_ref("G T=5000", llpt.loglik(q10, None, y10[:T_REF]), ref10)
    ref10a = float(llpt.loglik(angle_ukf("cpu", torch.float64), None,
                               ya[:T_TWIN], method="sequential"))
    rel10a = check_ref("G angle hook T=2000", llpt.loglik(ang10, None, yat),
                       ref10a, tol=1e-3)
    comp10 = ukf_scan._ukf_programs(q10, 0, dev)
    n_f, n_g = (len(p.instrs) for _, p in comp10.progs[:2])
    stats["ukf_scan"] = dict(
        max_abs_err=err10, T=T_SCAN, plain_T=T_TWIN, library_ms=None,
        ms=cuda_ms(lambda: ukf_scan.ukf_scan(q10, y10), 3),
        plain_ms=cuda_ms(lambda: ukf_scan.ukf_scan_plain(q10, y10t), 1),
        # ys; x0, P0, R1, R2; ll
        **bound(4 * (T_SCAN * 2 + 15),
                T_SCAN * per_step_ops_ukf(2, 2, n_f, n_g)))
    log("G ukf_scan", f"quadtank T={T_SCAN}: ll {ll10}; CV (forced) "
        f"{ll10cv}; angle hook T=4096 {ll10a}; T={T_REF} rel {rel10:.3g} "
        f"vs f64 sequential, angle hook T={T_TWIN} rel {rel10a:.3g} (1e-3, "
        f"bench.py:229); launches {path10}; {stats['ukf_scan']}")
    report("G", UKF, lambda: llpt.loglik(q10, None, y10), *ts10)
    log("G", f"CV UKF: tracing {ts10cv[0]} s, build {ts10cv[1]} s; angle "
        f"hook UKF: tracing {ts10a[0]} s, build {ts10a[1]} s")
    k0 = UKF.launches
    cv_ms = host_median_ms(lambda: llpt.ukf_loglik_fused(ukf8, y8,
                                                         force_kernel=True))
    log("G", f"CV UKF forced, median of 5: {cv_ms:.3f} ms, "
        f"{(UKF.launches - k0) / 6:g} launch(es) of G a call ({smi})")


FFBS_M, FFBS_SIZES = 1000, ((1000, 500), (65536, 24))  # (N, T), phase 11
#: RMS over steps and states of (FFBS smoothed mean - RTS mean) /
#: sqrt(RTS variance) that phase 11 accepts: the plain loop gives 0.15-0.24
#: at N = 1000 particles and M = 500 trajectories, a selection off by one
#: column about 1.5 (a CPU rehearsal of tests/test_torch_cuda.py)
FFBS_RMS_Z = 0.4


def ffbs_ops(T, N, M, nx):
    """Operations of kernel J: per (t, m, n) the score (2 nx + 3), the
    compare, a quarter Philox call, the two logs, the uniform (4) and two
    negations; per (t, m) the whitened state."""
    per_draw = 2 * nx + 4 + PHILOX_OPS / 4 + 2 + 4 + 2
    return (T - 1) * M * (N * per_draw + 3 * nx * (nx + 1) // 2 + 3 * nx)


def ffbs_bytes(T, N, M, nx):
    """zpred, wfc, c and xf of steps 0..T-2, xb_T, L⁻¹ and mu read once;
    the [T, M, nx] trajectories written once."""
    return 4 * ((T - 1) * (2 * N * nx + N + nx) + M * nx + nx * nx + nx
                + T * M * nx)


def ffbs_phase(dev, kernels, stats, launches, smi, data, model, kf):
    """Phase 11: the FFBS particle smoother on the bench_ffbs model
    (bench.py:552-564) at N = M = 1000, T = 500 and M = 1000, N = 65536,
    T = 24 (see the module doc)."""
    import lowlevelparticlefilters_jl_tpu_torch as llpt
    from lowlevelparticlefilters_jl_tpu_torch.kernels import ffbs
    from lowlevelparticlefilters_jl_tpu_torch.smoothing import (
        _predicted_means)

    J = ffbs.FFBS_BACKWARD
    cases = []
    for N, T in FFBS_SIZES:
        u, y, _ = data(T, seed=110 + T)
        cases.append((N, T, u, y, model(N, backend="kernel"),
                      u.float().to(dev), y.float().to(dev)))
    for k in kernels:
        k.launches = 0
    xbs = []
    for N, T, u, y, pf, uc, yc in cases:
        j0 = J.launches
        xb, ll = pf.smooth(uc, yc, M=FFBS_M, generator=torch.Generator(
            device=dev).manual_seed(SEED))
        torch.cuda.synchronize()
        require(llpt.last_route("smooth") == "cuda_ffbs_kernel"
                and J.launches == j0 + 1,
                f"pf.smooth N={N}: route {llpt.last_route('smooth')}, "
                f"{J.launches - j0} launches of J")
        require(xb.shape == (T, FFBS_M, 2) and bool(torch.isfinite(xb).all())
                and bool(torch.isfinite(ll)), f"N={N}: finite [T, M, 2]")
        xbs.append(xb)
    path = {k.name: k.launches for k in kernels}
    for name in ("ffbs_backward", "systematic_gather", "normal",
                 "add_gaussian_noise"):
        require(path[name] >= 1, f"phase 11 launched {name}")
    require(path["ffbs_backward"] == 2, f"one J a call: {path}")
    launches["ffbs_backward"] = path["ffbs_backward"]
    for name in ("systematic_gather", "normal", "add_gaussian_noise"):
        launches[name] += path[name]
    log("FFBS", f"pf.smooth M={FFBS_M} at (N, T) = {FFBS_SIZES}: route "
        f"cuda_ffbs_kernel; launches {path}")

    worst, rows = 0.0, []
    for (N, T, u, y, pf, uc, yc), xb in zip(cases, xbs):
        # the statistical check against the exact smoother
        ssol = llpt.rts_smooth(llpt.forward_trajectory(kf, u, y), kf)
        z = (llpt.smoothed_mean(xb).double().cpu() - ssol.xT) / \
            torch.diagonal(ssol.RT, dim1=-2, dim2=-1).sqrt()
        rms = float(z.square().mean().sqrt())
        require(rms < FFBS_RMS_Z, f"N={N}: FFBS mean within {FFBS_RMS_Z} RTS "
                f"deviations (RMS) of the exact smoother, got {rms:.3g}")
        # J against its twin on one fixed forward solution
        sol = pf.forward_trajectory(uc, yc, generator=torch.Generator(
            device=dev).manual_seed(SEED + 1))
        tvec = torch.arange(T - 1, dtype=torch.float32, device=dev)
        xpred = _predicted_means(pf.dynamics, sol.x[:-1], sol.u[:-1], tvec,
                                 None)
        d1 = pf.dynamics_density
        zpred, wfc, c, Linv = ffbs.whiten(xpred, sol.w[:-1], d1.chol())
        args = (zpred, wfc, c, sol.x[:-1].contiguous(),
                sol.x[-1][:FFBS_M].contiguous(), Linv, d1.mean.contiguous())
        apart = {}
        for noise_on in (False, True):
            out, idx = ffbs.ffbs_backward_scan(*args, 17, noise=noise_on,
                                               return_indices=True)
            ref, ridx = ffbs.ffbs_backward_plain(*args, 17, noise=noise_on,
                                                 return_indices=True)
            apart[noise_on] = float((idx != ridx).float().mean())
            worst = max(worst, float((out - ref).abs().max()))
        # MAP exact; with the same Philox stream at most 0.1 % of the
        # draws apart (a near-tie broken by one ulp), expected none
        require(apart[False] == 0.0, f"N={N}: J's MAP columns equal the "
                f"twin's ({apart[False]:.3g} apart)")
        require(apart[True] <= 1e-3, f"N={N}: J's Gumbel draws within 0.1 % "
                f"of the twin's ({apart[True]:.3g} apart)")
        ms = cuda_ms(lambda: ffbs.ffbs_backward_scan(*args, 17), 5)
        med = host_median_ms(lambda: pf.smooth(
            uc, yc, M=FFBS_M, generator=torch.Generator(device=dev)
            .manual_seed(SEED)))
        rows.append(dict(N=N, T=T, ms=ms, med=med, rms=rms, apart=apart,
                         args=args))
        log("FFBS", f"N={N} T={T} M={FFBS_M}: smoothed mean RMS {rms:.4f} "
            f"RTS deviations (bound {FFBS_RMS_Z}); J vs twin: MAP "
            f"{apart[False]:.3g}, noise {apart[True]:.3g} of the draws "
            f"apart; J {ms:.4f} ms by CUDA events; pf.smooth median of 5 "
            f"{med:.3f} ms, {(T - 1) * FFBS_M * N / med * 1e3:.4g} backward "
            f"weights/s ({smi})")
    main_row = rows[0]
    N, T = main_row["N"], main_row["T"]
    stats["ffbs_backward"] = dict(
        max_abs_err=worst, T=T, N=N, M=FFBS_M, library_ms=None,
        ms=main_row["ms"],
        plain_ms=cuda_ms(lambda: ffbs.ffbs_backward_plain(
            *main_row["args"], 17), 1),
        **bound(ffbs_bytes(T, N, FFBS_M, 2), ffbs_ops(T, N, FFBS_M, 2)))
    big = rows[1]
    log("J ffbs_backward", f"{stats['ffbs_backward']}; at N={big['N']} "
        f"T={big['T']}: {big['ms']:.4f} ms, bound "
        f"{bound(ffbs_bytes(big['T'], big['N'], FFBS_M, 2), ffbs_ops(big['T'], big['N'], FFBS_M, 2))}")


#: phase 13's bounds (see the module doc): RMS z-score of the PF's
#: filtered means against the float64 KF x(t|t), RMS relative error of its
#: variances against P(t|t); ESS >= 0.1 N = 1e4 puts the Monte-Carlo error
#: near 0.01 sd and 1.4 %
TRACK_Z, TRACK_VAR = 0.05, 0.05
T_TWIN_PF, T_SEG, T_ADV = 200, 100, 100  # phases 13-15


def pf_step_ops(nx, ny, weight=None):
    """Operations of kernel A per particle-step: the predict 4nx² + 4nx,
    one Philox call and nx normals, the weight (the whitened Gaussian
    2ny·nx + 2ny² + 4ny unless given) and the normalization ~12."""
    w = 2 * ny * nx + 2 * ny * ny + 4 * ny if weight is None else weight
    return 4 * nx * nx + 4 * nx + w + 12 + PHILOX_OPS + nx * NORMAL_OPS


def pf_resample_ops(N, nres, nx):
    """Per particle of each resampling step: the quantized scan, the slot
    and its binary search, the row copy."""
    return nres * N * (30 + 2 * math.ceil(math.log2(N)) + nx)


def held_pf(what, got, want, fields=(), exact=False):
    """A kernel-A mode against its twin: the resample count exactly, ll
    within 1e-5 relative (or equal), the named outputs within rtol 2e-4,
    atol 1e-5 (sums in another order); the largest absolute difference."""
    llg, llw = float(got["ll"]), float(want["ll"])
    require(float(got["nres"]) == float(want["nres"]),
            f"{what}: resamples {float(got['nres'])} vs "
            f"{float(want['nres'])}")
    require(llg == llw if exact else abs(llg - llw) <= 1e-5 * abs(llw),
            f"{what}: ll {llg} vs the twin's {llw}")
    err = abs(llg - llw)
    for name in fields:
        require(torch.allclose(got[name], want[name], rtol=2e-4, atol=1e-5),
                f"{what}: {name} within rtol 2e-4, atol 1e-5 of the twin")
        err = max(err, float((got[name] - want[name]).abs().max()))
    return err


def tracking_phases(dev, kernels, stats, launches, smi, data, model, kf,
                    lattice_case):
    """Phases 13-15: PF state tracking (kernel A's moments, segment and
    scalar-density modes), kernel E, and the auxiliary and advanced
    particle filters (see the module doc)."""
    import lowlevelparticlefilters_jl_tpu_torch as llpt
    from lowlevelparticlefilters_jl_tpu_torch.kernels import (
        pf_scan, resample_route, resample_v2)
    from lowlevelparticlefilters_jl_tpu_torch.ops import resample as ors

    MOM, SEG, DEN = (pf_scan.PF_MOMENTS_SCAN, pf_scan.PF_SEGMENT_SCAN,
                     pf_scan.PF_DENSITY_SCAN)
    E, Bk = resample_v2.SYSTEMATIC_INDEX_GATHER, resample_route.SYSTEMATIC_GATHER
    N = N_MAIN
    g = torch.Generator(device=dev)
    gcpu = torch.Generator().manual_seed(SEED + 13)

    def randn(*shape):
        return torch.randn(*shape, generator=gcpu).to(dev)

    def counts():
        return {k.name: k.launches for k in kernels}

    def resamples(sol, thresh=THRESH):
        return int((1.0 / (sol.we ** 2).sum(-1) < thresh * sol.we.shape[-1])
                   .sum())

    # ---- 13. PF state tracking -------------------------------------------
    u, y, ll_kf = data(T_MAIN, seed=13)
    uc, yc = u.float().to(dev), y.float().to(dev)
    ksol = llpt.forward_trajectory(kf, u, y)  # float64 x(t|t), P(t|t)
    pf = model(N)
    pfd = pf.replace(measurement_density=llpt.TupleProduct(
        [llpt.StudentT(4.0, 0.0, 0.3), llpt.Laplace(0.0, 0.25)]))
    x0, w0 = randn(N, 2), torch.full((N,), -math.log(N), device=dev)
    for k in kernels:
        k.launches = 0
    means = llpt.mean_trajectory(pf, uc, yc, generator=g.manual_seed(SEED))
    route = llpt.last_route("mean_trajectory")
    require(route == "cuda_fused_scan" and MOM.launches == 1,
            f"mean_trajectory: route {route}, {MOM.launches} launches")
    m2, covs, ll2, nres2 = llpt.pf_stats_fused(pf, uc, yc, SEED)
    ll_seg, x_fin, w_fin = llpt.pf_segment_fused(pf, uc[:T_SEG], yc[:T_SEG],
                                                 SEED, x0, w0)
    ll_d = float(pfd.loglik(uc, yc, generator=g.manual_seed(SEED)))
    route_d = llpt.last_route("loglik")
    path13 = counts()
    require(path13["pf_moments_scan"] == 2 and path13["pf_segment_scan"] == 1
            and path13["pf_density_scan"] == 1 and sum(path13.values()) == 4
            and route_d == "cuda_fused_scan",
            f"phase 13 launches {path13}, density route {route_d}")
    for name in ("pf_moments_scan", "pf_segment_scan", "pf_density_scan"):
        launches[name] = path13[name]
    sd2 = torch.diagonal(ksol.Rt, dim1=-2, dim2=-1)
    zs = [float((((mm.double().cpu() - ksol.xt) / sd2.sqrt()) ** 2).mean()
                .sqrt()) for mm in (means, m2)]
    vrel = float((((torch.diagonal(covs, dim1=-2, dim2=-1).double().cpu()
                    - sd2) / sd2) ** 2).mean().sqrt())
    rel2 = abs(float(ll2) - ll_kf) / abs(ll_kf)
    require(max(zs) <= TRACK_Z and vrel <= TRACK_VAR and rel2 < 0.01
            and means.shape == (T_MAIN, 2) and covs.shape == (T_MAIN, 2, 2),
            f"means RMS z {zs} (bound {TRACK_Z}), variances RMS rel {vrel:.4g}"
            f" (bound {TRACK_VAR}), stats ll rel {rel2:.3g}")
    # segment: no resampling, so ll_local + lse(w_fin) is the loglik mode's
    # ll from the same cloud and Philox stream
    ll_full, _ = pf_scan.pf_loglik_fused(pf.replace(resample_threshold=0.0),
                                         uc[:T_SEG], yc[:T_SEG], SEED, x0=x0)
    seg_tot = float(ll_seg) + float(torch.logsumexp(w_fin, 0))
    require(abs(seg_tot - float(ll_full)) <= 1e-5 * abs(float(ll_full))
            and x_fin.shape == (N, 2) and bool(torch.isfinite(x_fin).all()),
            f"segment ll_local + lse(w_fin) {seg_tot} vs loglik mode "
            f"{float(ll_full)}")
    lls_seq = [float(pfd.loglik(uc, yc, generator=g.manual_seed(s),
                                method="sequential")) for s in (1, 2, 3)]
    ref_d = statistics.mean(lls_seq)
    rel_d = abs(ll_d - ref_d) / abs(ref_d)
    require(rel_d < 0.01, f"scalar-density ll {ll_d} within 1 % of the "
            f"sequential route's mean {ref_d} ({lls_seq})")
    med_mean = host_median_ms(lambda: llpt.mean_trajectory(
        pf, uc, yc, generator=g))
    med_stats = host_median_ms(lambda: llpt.pf_stats_fused(pf, uc, yc, SEED))
    med_dens = host_median_ms(lambda: pfd.loglik(uc, yc, generator=g))
    log("tracking", f"N={N} T={T_MAIN}: mean_trajectory route {route}, "
        f"means RMS z {zs[0]:.4f} (pf_stats_fused {zs[1]:.4f}), variances "
        f"RMS rel {vrel:.4f} vs the float64 KF; stats ll {float(ll2)} KF "
        f"{ll_kf} rel {rel2:.3g}; segment T={T_SEG} ll_local "
        f"{float(ll_seg)} + lse(w_fin) = {seg_tot} vs loglik mode "
        f"{float(ll_full)}; TupleProduct(StudentT, Laplace) ll {ll_d} vs "
        f"sequential mean {ref_d} rel {rel_d:.3g}; launches {path13}")
    log("tracking", f"medians of 5: mean_trajectory {med_mean:.3f} ms, "
        f"pf_stats_fused {med_stats:.3f} ms, pf.loglik (scalar density) "
        f"{med_dens:.3f} ms ({smi})")

    # each mode against its twin at T = 200: no noise and the same Philox
    # stream at threshold 0 (no resampling: sums in another order only),
    # and the lattice case (exact resampling)
    ut, yt = uc[:T_TWIN_PF], yc[:T_TWIN_PF]
    args_t = pf_scan.scan_inputs(pf, ut, yt)
    args_d = pf_scan.scan_inputs(pfd, ut, yt)
    dens = pf_scan.scan_density(pfd, dev)
    w0r = randn(N)
    err = dict(pf_moments_scan=0.0, pf_segment_scan=0.0, pf_density_scan=0.0)
    for noise_kind in ("none", "philox"):
        kw = dict(N=N, thresh=0.0, seed=SEED, noise=noise_kind, x0=x0)
        err["pf_moments_scan"] = max(err["pf_moments_scan"], held_pf(
            f"moments {noise_kind}", pf_scan.pf_scan(*args_t, moments=2, **kw),
            pf_scan.pf_scan_plain(*args_t, moments=2, **kw),
            ("means", "covs")))
        seg = dict(kw, w0=w0r, segment=True)
        got, want = (f(*args_t, **seg) for f in (pf_scan.pf_scan,
                                                 pf_scan.pf_scan_plain))
        require(torch.allclose(got["x_fin"], want["x_fin"], rtol=1e-5,
                               atol=1e-5)
                and torch.allclose(got["w_fin"], want["w_fin"], rtol=1e-5,
                                   atol=1e-4),
                f"segment {noise_kind}: x_fin, w_fin against the twin")
        err["pf_segment_scan"] = max(err["pf_segment_scan"], held_pf(
            f"segment {noise_kind}", got, want))
        err["pf_density_scan"] = max(err["pf_density_scan"], held_pf(
            f"density {noise_kind}", pf_scan.pf_scan(*args_d, dens=dens, **kw),
            pf_scan.pf_scan_plain(*args_d, dens=dens, **kw)))
    pf4, u4, y4, x04 = lattice_case(N, T_TWIN_PF, dev)
    args4 = pf_scan.scan_inputs(pf4, u4, y4)
    kw4 = dict(N=N, thresh=float(pf4.resample_threshold), seed=SEED,
               noise="none", x0=x04)
    got, want = (f(*args4, moments=2, **kw4) for f in (
        pf_scan.pf_scan, pf_scan.pf_scan_plain))
    require(torch.equal(got["means"], want["means"])
            and 1 <= float(want["nres"]) < T_TWIN_PF,
            "moments lattice: means equal, some resamples")
    held_pf("moments lattice", got, want, ("covs",), exact=True)
    log("tracking", f"modes against their twins at T={T_TWIN_PF}: largest "
        f"differences {err}; lattice {float(want['nres'])} resamples, means "
        f"equal")

    # kernel times at the main path's shape, twins at T = 200
    args_m = pf_scan.scan_inputs(pf, uc, yc)
    args_md = pf_scan.scan_inputs(pfd, uc, yc)
    kw_m = dict(N=N, thresh=THRESH, seed=SEED)
    nres_m = float(pf_scan.pf_scan(*args_m, moments=2, **kw_m)["nres"])
    nres_d = float(pf_scan.pf_scan(*args_md, dens=dens, **kw_m)["nres"])
    in_bytes = sum(a.numel() * a.element_size() for a in args_m) + 8
    np_ = 3  # pairs at nx = 2
    stats["pf_moments_scan"] = dict(
        max_abs_err=err["pf_moments_scan"], T=T_MAIN, plain_T=T_TWIN_PF,
        library_ms=None,  # no PyTorch call filters
        ms=cuda_ms(lambda: pf_scan.pf_scan(*args_m, moments=2, **kw_m), 5),
        plain_ms=cuda_ms(lambda: pf_scan.pf_scan_plain(
            *args_t, moments=2, **kw_m), 1),
        # A's work plus, per particle-step, the weighted sums (2 nx), the
        # centring (nx) and the pair products (3 per pair)
        **bound(in_bytes + 4 * T_MAIN * (2 + 4),
                N * T_MAIN * (pf_step_ops(2, 2) + 3 * 2 + 3 * np_)
                + pf_resample_ops(N, nres_m, 2)))
    kw_s = dict(N=N, thresh=THRESH, seed=SEED, x0=x0, w0=w0, segment=True)
    stats["pf_segment_scan"] = dict(
        max_abs_err=err["pf_segment_scan"], T=T_MAIN, plain_T=T_TWIN_PF,
        library_ms=None,
        ms=cuda_ms(lambda: pf_scan.pf_scan(*args_m, **kw_s), 5),
        plain_ms=cuda_ms(lambda: pf_scan.pf_scan_plain(*args_t, **kw_s), 1),
        # the inputs, x0 and w0 in, x_fin and w_fin out; no resampling
        **bound(in_bytes + 2 * 4 * N * 3, N * T_MAIN * pf_step_ops(2, 2)))
    stats["pf_density_scan"] = dict(
        max_abs_err=err["pf_density_scan"], T=T_MAIN, plain_T=T_TWIN_PF,
        library_ms=None,
        ms=cuda_ms(lambda: pf_scan.pf_scan(*args_md, dens=dens, **kw_m), 5),
        plain_ms=cuda_ms(lambda: pf_scan.pf_scan_plain(
            *args_d, dens=dens, **kw_m), 1),
        # the weight: ŷ and e (2 ny nx + ny), StudentT 7, Laplace 4, the
        # sum ny
        **bound(in_bytes + 4 * 2 * 7,
                N * T_MAIN * pf_step_ops(2, 2, weight=8 + 2 + 7 + 4 + 2)
                + pf_resample_ops(N, nres_d, 2)))
    for name in ("pf_moments_scan", "pf_segment_scan", "pf_density_scan"):
        log(f"A {name}", f"N={N} T={T_MAIN}: {stats[name]}")

    # ---- 14. kernel E -------------------------------------------------------
    worst_e = 0.0
    for nx in (2, 8):
        x = randn(N, nx)
        for kind in ("random", "skewed", "single"):
            we = torch.rand(N, generator=gcpu, dtype=torch.float64)
            if kind == "skewed":
                we = we ** 20
            elif kind == "single":
                we = torch.zeros(N, dtype=torch.float64)
                we[N // 3] = 1.0
            K = ors._systematic_slots((we / we.sum()).to(dev), torch.tensor(
                0.37, dtype=torch.float64, device=dev), N)
            out, j = resample_v2.systematic_index_gather(x, K)
            ref, jr = resample_v2.systematic_index_gather_plain(x, K)
            require(torch.equal(out, ref) and torch.equal(j, jr),
                    f"E bitwise, nx={nx} {kind}")
            require(kind != "single" or bool((j == N // 3).all()),
                    "E single particle")
            worst_e = max(worst_e, float((out - ref).abs().max()))
            if nx == 2 and kind == "skewed":
                x2, K2 = x, K
    ar = torch.arange(N, dtype=torch.int32, device=dev)
    lib_e = cuda_ms(lambda: x2.index_select(0, torch.searchsorted(
        K2, ar, right=True).clamp_(max=N - 1)), 20)
    stats["systematic_index_gather"] = dict(
        max_abs_err=worst_e, N=N, nx=2,
        # searchsorted + index_select is two PyTorch calls, not one
        library_ms=None,
        ms=cuda_ms(lambda: resample_v2.systematic_index_gather(x2, K2), 50),
        plain_ms=cuda_ms(lambda: resample_v2.systematic_index_gather_plain(
            x2, K2), 20),
        **bound(4 * (2 * N * 2 + 2 * N),
                N * (2 * math.ceil(math.log2(N)) + 2)))
    log("E systematic_index_gather", f"bitwise at N={N}, nx 2 and 8, random,"
        f" U^20 and single-particle weights; searchsorted + index_select "
        f"(two calls) {lib_e:.4f} ms; {stats['systematic_index_gather']}")
    u14, y14, ll_kf14 = data(100, seed=14)
    u14c, y14c = u14.float().to(dev), y14.float().to(dev)
    for k in kernels:
        k.launches = 0
    sol_e = pf.replace(exact_resample=True).forward_trajectory(
        u14c, y14c, generator=g.manual_seed(SEED))
    path14 = counts()
    n14 = resamples(sol_e)
    sol_b = pf.forward_trajectory(u14c, y14c, generator=g.manual_seed(SEED))
    rel14 = abs(float(sol_e.ll) - ll_kf14) / abs(ll_kf14)
    require(path14["systematic_index_gather"] == n14 >= 1
            and path14["systematic_gather"] == 0 and rel14 < 0.01
            and Bk.launches == n14,
            f"exact_resample: E launches {path14} vs {n14} resamples, B "
            f"{Bk.launches}; ll rel {rel14:.3g}")
    require(all(torch.equal(getattr(sol_e, f), getattr(sol_b, f))
                for f in ("x", "w", "we", "ll")),
            "exact_resample (E) and default (B) runs are bitwise equal")
    launches["systematic_index_gather"] = path14["systematic_index_gather"]
    log("E", f"forward_trajectory exact_resample N={N} T=100: {n14} "
        f"resamples, E launches {path14['systematic_index_gather']}, ll "
        f"{float(sol_e.ll)} KF {ll_kf14} rel {rel14:.3g}; bitwise equal to "
        f"the kernel-B run")

    # ---- 15. the auxiliary and advanced particle filters -------------------
    # the APF's correct step only normalizes, so y[0] is never scored (as
    # in the reference), about 1 % of |ll| at T = 100: T = 1000 here
    A_, B_, C_ = (torch.tensor(M, dtype=torch.float32, device=dev)
                  for M in ([[0.97043, -0.097368], [0.097368, 0.970437]],
                            [[0.1], [0.0]], [[1.0, 0.0], [0.0, 1.0]]))
    L1_ = torch.linalg.cholesky(pf.dynamics_density.cov)
    dm_ = pf.measurement_density

    def advanced(exact):
        return llpt.AdvancedParticleFilter(
            N=N, dynamics=lambda x, u, p, t, z: A_ @ x + B_ @ u + (
                0 if z is None else L1_ @ z),
            measurement=lambda x, u, p, t, z: C_ @ x,
            measurement_likelihood=lambda x, u, y, p, t: dm_.logpdf(
                y - C_ @ x),
            initial_density=pf.initial_density, resample_threshold=THRESH,
            exact_resample=exact)

    u15, y15, ll_kf15 = data(T_ADV, seed=15)
    u15c, y15c = u15.float().to(dev), y15.float().to(dev)
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    sol_a = llpt.AuxiliaryParticleFilter(pf=pf).forward_trajectory(
        uc, yc, generator=g.manual_seed(SEED))
    torch.cuda.synchronize()
    t_apf = time.perf_counter() - t0
    sol_ae = llpt.AuxiliaryParticleFilter(
        pf=pf.replace(exact_resample=True)).forward_trajectory(
        uc, yc, generator=g.manual_seed(SEED))
    ll_adv = float(advanced(False).loglik(u15c, y15c,
                                          generator=g.manual_seed(SEED)))
    ll_adve = float(advanced(True).loglik(u15c, y15c,
                                          generator=g.manual_seed(SEED)))
    path15 = counts()
    adv_res = path15["systematic_gather"] - (T_MAIN - 1)
    rel_a = abs(float(sol_a.ll) - ll_kf) / abs(ll_kf)
    rel_adv = abs(ll_adv - ll_kf15) / abs(ll_kf15)
    require(adv_res >= 1 and path15["systematic_index_gather"]
            == T_MAIN - 1 + adv_res,
            f"phase 15 launches {path15}: B and E once a predict of the APF "
            f"and once a resample of the advanced filter")
    require(all(torch.equal(getattr(sol_a, f), getattr(sol_ae, f))
                for f in ("x", "w", "we", "ll")) and ll_adv == ll_adve,
            "APF and advanced filter: E runs bitwise equal to B runs")
    require(rel_a < 0.01 and rel_adv < 0.01,
            f"APF ll {float(sol_a.ll)} vs KF {ll_kf} (rel {rel_a:.3g}), "
            f"advanced ll {ll_adv} vs KF {ll_kf15} (rel {rel_adv:.3g})")
    launches["systematic_index_gather"] += path15["systematic_index_gather"]
    log("APF", f"N={N} T={T_MAIN}: ll {float(sol_a.ll)} KF {ll_kf} rel "
        f"{rel_a:.3g}, one forward_trajectory {t_apf * 1e3:.1f} ms; advanced "
        f"PF T={T_ADV}: ll {ll_adv} KF {ll_kf15} rel {rel_adv:.3g}; E runs "
        f"bitwise equal to B runs; launches {path15}")


def smoother_phase(dev, kernels, stats, launches, smi, A, B, C, R1, R2):
    """Phase 12: the RTS family on CUDA tensors (see the module doc)."""
    import lowlevelparticlefilters_jl_tpu_torch as llpt
    from lowlevelparticlefilters_jl_tpu_torch import convert
    from lowlevelparticlefilters_jl_tpu_torch.kernels import ukf_scan

    kf64 = convert.kalman_filter_from_numpy(A, B, C, 0, R1, R2, device="cpu")
    kf32 = convert.kalman_filter_from_numpy(A, B, C, 0, R1, R2,
                                            dtype=torch.float32, device=dev)
    g = torch.Generator().manual_seed(120)
    u_par = torch.full((T_PAR, 1), 0.3, dtype=torch.float64)
    y_par = 0.3 * torch.randn(T_PAR, 2, generator=g, dtype=torch.float64)
    ys = {"cv": torch.randn(T_SCAN, 2, generator=g, dtype=torch.float64),
          "quadtank": 1.0 + 0.1 * torch.randn(T_SCAN, 2, generator=g,
                                              dtype=torch.float64),
          "ekf": torch.randn(T_SCAN, 2, generator=g, dtype=torch.float64)}
    models = {"cv": cv_ukf, "quadtank": quadtank_ukf, "ekf": nonlinear_ekf}
    f32 = {k: b(dev, torch.float32) for k, b in models.items()}
    f64 = {k: b("cpu", torch.float64) for k, b in models.items()}
    uc, yc = u_par.float().to(dev), y_par.float().to(dev)
    G, K = ukf_scan.UKF_SCAN, [k for k in kernels if k.name == "assoc_scan"][0]
    for k in kernels:
        k.launches = 0
    sm_kf = llpt.smooth(kf32, uc, yc)
    require(llpt.last_route("smooth") == "cuda_temporal_parallel",
            f"smooth(kf) T={T_PAR}: route {llpt.last_route('smooth')}")
    outs = {}
    for name, f in f32.items():
        outs[name] = llpt.smooth(f, None, ys[name].float().to(dev))
        require(llpt.last_route("smooth") == "cuda_temporal_parallel"
                and bool(torch.isfinite(outs[name].xT).all()),
                f"smooth({name}) T={T_SCAN}: route "
                f"{llpt.last_route('smooth')}")
    q4 = llpt.parallel_ukf_smooth(f32["quadtank"], None,
                                  ys["quadtank"].float().to(dev), iters=4)
    yq2k = ys["quadtank"][:T_TWIN].float().to(dev)
    fused = f32["quadtank"].smooth(None, yq2k, fused=True)
    path = {k.name: k.launches for k in kernels}
    require(path["ukf_scan"] == 1 and path["assoc_scan"] >= 1
            and path["akf_scan"] == path["ekf_scan"] == 0,
            f"phase 12 launches: {path}")
    launches["ukf_scan"] += path["ukf_scan"]
    launches["assoc_scan"] += path["assoc_scan"]

    tol = dict(rtol=1e-3, atol=1e-4)

    def held(what, got, want):
        for fld in ("xT", "RT"):
            a, b = getattr(got, fld).double().cpu(), getattr(want, fld)
            require(torch.allclose(a, b, **tol), f"{what}: {fld} within "
                    f"rtol 1e-3, atol 1e-4 of float64 CPU")
        return float((got.xT.double().cpu() - want.xT).abs().max())

    errs = {"kf": held("smooth(kf) T=1e5", sm_kf, llpt.smooth(
        kf64, u_par, y_par, method="parallel"))}
    u2k, y2k = u_par[:T_TWIN], y_par[:T_TWIN]
    seq = llpt.smooth(kf32, u2k.float().to(dev), y2k.float().to(dev),
                      method="sequential")
    require(llpt.last_route("smooth") == "sequential", "sequential route")
    errs["kf sequential"] = held("smooth(kf, sequential) T=2000", seq,
                                 llpt.smooth(kf64, u2k, y2k,
                                             method="sequential"))
    sol32 = llpt.forward_trajectory(kf32, u2k.float().to(dev),
                                    y2k.float().to(dev))
    sol64 = llpt.forward_trajectory(kf64, u2k, y2k, method="sequential")
    errs["mbf"] = held("smooth_mbf T=2000", llpt.smooth_mbf(sol32, kf32)[0],
                       llpt.smooth_mbf(sol64, kf64)[0])
    for name in f32:
        y5k = ys[name][:T_REF]
        got = llpt.smooth(f32[name], None, y5k.float().to(dev))
        errs[name] = held(f"smooth({name}) T={T_REF}", got, llpt.smooth(
            f64[name], None, y5k, method="parallel"))
    errs["quadtank iters=4"] = held(
        f"parallel_ukf_smooth(quadtank, iters=4) T={T_REF}",
        llpt.parallel_ukf_smooth(f32["quadtank"], None,
                                 ys["quadtank"][:T_REF].float().to(dev),
                                 iters=4),
        llpt.parallel_ukf_smooth(f64["quadtank"], None,
                                 ys["quadtank"][:T_REF], iters=4))
    errs["fused"] = held(f"quadtank smooth(fused=True) T={T_TWIN}", fused,
                         f64["quadtank"].smooth(None,
                                                ys["quadtank"][:T_TWIN]))
    require(bool(torch.isfinite(q4.xT).all()), "iters=4 finite")
    log("smooth", f"routes cuda_temporal_parallel (KF T={T_PAR}; CV, "
        f"quadtank, EKF T={T_SCAN}); largest |xT - f64| {errs}; "
        f"launches {path}")
    meds = {"kf T=1e5": host_median_ms(lambda: llpt.smooth(kf32, uc, yc))}
    for name, f in f32.items():
        yy = ys[name].float().to(dev)
        k0 = K.launches
        meds[name] = host_median_ms(lambda: llpt.smooth(f, None, yy))
        meds[name + " K/call"] = (K.launches - k0) / 6
    yy = ys["quadtank"].float().to(dev)
    meds["quadtank iters=4"] = host_median_ms(
        lambda: llpt.parallel_ukf_smooth(f32["quadtank"], None, yy, iters=4))
    log("smooth", "medians of 5 (ms; T = 5e4 unless named): "
        + ", ".join(f"{k} {v:.3f}" for k, v in meds.items()) + f" ({smi})")


def main():
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    sys.path[:0] = [str(root), str(root / "tests")]
    import lowlevelparticlefilters_jl_tpu_torch as llpt
    from _torch_parity import lattice_case
    from lowlevelparticlefilters_jl_tpu_torch import convert
    from lowlevelparticlefilters_jl_tpu_torch.filters import bank as tbank
    from lowlevelparticlefilters_jl_tpu_torch.kernels import (
        _lib, assoc_scan, bank_scan, ffbs, noise, pf_scan, resample_route,
        resample_v2, ukf_scan)
    from lowlevelparticlefilters_jl_tpu_torch.ops import resample as ors
    from lowlevelparticlefilters_jl_tpu_torch.parallel import temporal

    dev = torch.device("cuda")
    kernels = [pf_scan.PF_LOGLIK_SCAN, resample_route.SYSTEMATIC_GATHER,
               noise.NORMAL, noise.ADD_GAUSSIAN_NOISE, bank_scan.BANK_LOGLIK,
               ukf_scan.UKF_SCAN, ukf_scan.AKF_SCAN, ukf_scan.EKF_SCAN,
               ffbs.FFBS_BACKWARD, assoc_scan.ASSOC_SCAN,
               pf_scan.PF_MOMENTS_SCAN, pf_scan.PF_SEGMENT_SCAN,
               pf_scan.PF_DENSITY_SCAN, resample_v2.SYSTEMATIC_INDEX_GATHER]
    stats = {k.name: {} for k in kernels}
    launches = {}

    # ---- 1. device --------------------------------------------------------
    smi = nvidia_smi_line()
    nvcc = subprocess.run([_lib._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("device", f"{smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {nvcc[-1]} | allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32}")

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    lib = _lib.library()
    log("build", f"{lib.path.name}: nvcc {lib.build_seconds:.1f} s, load "
        f"{time.perf_counter() - t0:.1f} s")
    for name, regs, spill in register_table(lib.log):
        log("build", f"{name}: {regs} registers, {spill} bytes spilled")

    # the benchmark's model and data: KF simulate in f64 on the CPU
    A = [[0.97043, -0.097368], [0.097368, 0.970437]]
    B, C = [[0.1], [0.0]], [[1.0, 0.0], [0.0, 1.0]]
    R1 = [[0.01, 0.0], [0.0, 0.01]]
    R2 = [[0.1, 0.0], [0.0, 0.1]]
    kf = convert.kalman_filter_from_numpy(A, B, C, 0, R1, R2, device="cpu")

    def data(T, seed=1):
        u = torch.full((T, 1), 0.3, dtype=torch.float64)
        _, u, y = llpt.simulate(kf, u, torch.Generator().manual_seed(seed))
        return u, y, float(llpt.loglik(kf, u, y))

    def model(N, C_=C, threshold=THRESH, backend="torch"):
        f, g = convert.linear_callbacks(A, B, C_, device=dev)
        return convert.particle_filter_from_numpy(
            N, f, g, R1, R2, R1, resample_threshold=threshold,
            noise_backend=backend, device=dev)

    # ---- 3. kernels against their plain twins -----------------------------
    # C: the raw Philox words must be identical to the plain twin's and to
    # curand's Philox4x32-10; normals within 1e-6 absolute (the same words,
    # with logf/sincosf against torch's log/cos/sin, a few ulps of |z| < 6).
    ctr = torch.randint(0, 2**32, (1 << 16, 4), dtype=torch.int64,
                        generator=torch.Generator().manual_seed(SEED))
    key = (0x01234567, 0x89ABCDEF)
    ref_bits = noise.philox_bits(ctr, key)
    require(torch.equal(noise.philox_bits(ctr.to(dev), key).cpu(), ref_bits),
            "Philox words equal the plain twin")
    require(torch.equal(noise.philox_bits(ctr.to(dev), key, curand=True)
                        .cpu(), ref_bits), "Philox words equal curand's")
    kat = noise.philox_bits(torch.zeros(1, 4, dtype=torch.int64,
                                        device=dev), (0, 0))
    require(kat[0].tolist() == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C,
                                0x9B00DBD8], "Random123 known answer")
    shape = (N_MAIN, 2)  # the initial cloud's draws
    z = noise.normal(7, shape, tag=noise.TAG_INIT, device=dev)
    zp = noise.normal_plain(7, N_MAIN * 2, tag=noise.TAG_INIT,
                            device=dev).reshape(shape)
    err = float((z - zp).abs().max())
    require(err <= 1e-6, f"normal within 1e-6 (got {err:.3g})")
    stats["normal"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: noise.normal(7, shape, tag=noise.TAG_INIT,
                                        device=dev), 50),
        plain_ms=cuda_ms(lambda: noise.normal_plain(
            7, N_MAIN * 2, tag=noise.TAG_INIT, device=dev), 5),
        # the same distribution from another stream, in one PyTorch call
        library_ms=cuda_ms(lambda: torch.randn(shape, device=dev), 50),
        **bound(4 * N_MAIN * 2, -(-N_MAIN * 2 // 4) * PHILOX_OPS
                + N_MAIN * 2 * NORMAL_OPS))
    log("C normal", f"bits == plain == curand over {ctr.shape[0]} counters; "
        f"KAT ok; {stats['normal']}")

    # D: within 1e-6 (the same normals; fused multiply-adds against torch's
    # matmul round differently in the last ulp of values below 1).
    xn = torch.randn(N_MAIN, 2, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(SEED))
    L1 = torch.linalg.cholesky(torch.tensor(R1, device=dev))
    err = float((noise.add_gaussian_noise(xn, L1, 11, 3)
                 - noise.add_gaussian_noise_plain(xn, L1, 11, 3)).abs().max())
    require(err <= 1e-6, f"add_gaussian_noise within 1e-6 (got {err:.3g})")
    stats["add_gaussian_noise"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: noise.add_gaussian_noise(xn, L1, 11, 3), 50),
        plain_ms=cuda_ms(lambda: noise.add_gaussian_noise_plain(
            xn, L1, 11, 3), 5),
        library_ms=None,  # noise, then a product and a sum: no one call
        **bound(4 * (2 * N_MAIN * 2 + 4),
                N_MAIN * (PHILOX_OPS + 2 * NORMAL_OPS + 2 * 4 + 2)))
    log("D add_gaussian_noise", stats["add_gaussian_noise"])

    # B: bitwise (the kernel copies values; K comes from the same plain
    # _systematic_slots).
    gcpu = torch.Generator().manual_seed(SEED)
    worst = 0.0
    for nx in (2, 4):
        x = torch.randn(N_MAIN, nx, generator=gcpu, device="cpu").to(dev)
        for kind in ("uniform", "skewed"):
            we = (torch.ones(N_MAIN, dtype=torch.float64) if kind == "uniform"
                  else torch.rand(N_MAIN, generator=gcpu,
                                  dtype=torch.float64) ** 20).to(dev)
            K = ors._systematic_slots(we / we.sum(), torch.tensor(
                0.37, dtype=torch.float64, device=dev), N_MAIN)
            out = resample_route.systematic_gather(x, K)
            ref = resample_route.systematic_gather_plain(x, K)
            require(torch.equal(out, ref), f"gather bitwise, nx={nx} {kind}")
            worst = max(worst, float((out - ref).abs().max()))
            if nx == 2 and kind == "skewed":
                stats["systematic_gather"] = dict(
                    ms=cuda_ms(lambda: resample_route.systematic_gather(
                        x, K), 50),
                    plain_ms=cuda_ms(
                        lambda: resample_route.systematic_gather_plain(x, K),
                        20))
    # a row gather by slot boundaries is searchsorted + index_select: two
    # PyTorch calls, so no library time
    stats["systematic_gather"].update(
        max_abs_err=worst, library_ms=None,
        **bound(4 * (2 * N_MAIN * 2 + N_MAIN),
                N_MAIN * (2 * math.ceil(math.log2(N_MAIN)) + 2)))
    log("B systematic_gather", f"bitwise at N={N_MAIN}, nx 2 and 4, "
        f"uniform and U^20 weights; {stats['systematic_gather']}")

    # A at N = 1e5, T = 200, four cases (see the tolerance notes).
    u2, y2, _ = data(200, seed=2)
    u2, y2 = u2.float().to(dev), y2.float().to(dev)
    x0 = torch.randn(N_MAIN, 2, generator=gcpu).to(dev)
    worst = 0.0

    def both(pf, **kw):
        """Kernel A and its plain twin on the same CUDA inputs."""
        args = pf_scan.scan_inputs(pf, u2, y2)
        kw = dict(N=pf.N, thresh=float(pf.resample_threshold), seed=SEED,
                  **kw)
        k = pf_scan.pf_loglik_scan(*args, **kw)
        p = pf_scan.pf_loglik_scan_plain(*args, **kw)
        return float(k[0]), float(k[1]), float(p[0]), float(p[1])

    # (i) no noise, never resamples: only the order of the grid sums
    # differs, so rtol 1e-5
    llk, nk, llp, npl = both(model(N_MAIN, threshold=0.0), x0=x0,
                             noise="none")
    require(abs(llk - llp) <= 1e-5 * abs(llp) and nk == npl == 0,
            f"A no-noise threshold 0: {llk} vs {llp}, {nk} vs {npl}")
    worst = max(worst, abs(llk - llp))
    log("A case i", f"noise none, threshold 0: kernel {llk} plain {llp} "
        f"resamples {nk}/{npl} (rtol 1e-5: sum order only)")
    # (ii) no noise, always resample, state-free measurement: equal
    # weights make the selection the identity, so rtol 1e-5 and T resamples
    llk, nk, llp, npl = both(model(N_MAIN, C_=[[0.0, 0.0], [0.0, 0.0]],
                                   threshold=1.0), x0=x0, noise="none")
    require(abs(llk - llp) <= 1e-5 * abs(llp) and nk == npl == 200,
            f"A always-resample: {llk} vs {llp}, {nk} vs {npl}")
    worst = max(worst, abs(llk - llp))
    log("A case ii", f"noise none, always resample, state-free measurement: "
        f"kernel {llk} plain {llp} resamples {nk}/{npl} (rtol 1e-5; "
        f"identity selection)")
    # (iii) Philox noise, threshold 0.1, same seed: a one-quantum shift of
    # the quantized weights from the sum order can move one slot boundary
    # and the paths then diverge in distribution only, so rtol 1e-3 and the
    # resample counts within 2
    llk, nk, llp, npl = both(model(N_MAIN))
    require(abs(llk - llp) <= 1e-3 * abs(llp) and abs(nk - npl) <= 2,
            f"A philox: {llk} vs {llp}, {nk} vs {npl}")
    worst = max(worst, abs(llk - llp))
    log("A case iii", f"philox, threshold 0.1: kernel {llk} plain {llp} "
        f"resamples {nk}/{npl} (rtol 1e-3, +-2: a one-quantum weight shift "
        f"from the sum order can move one slot boundary)")
    # (iv) no noise, a state-dependent measurement, real selections: the
    # lattice case of tests/_torch_parity.py, where every weight is 0 or
    # 1, so the sums, quantized weights, K and gathers agree in any order:
    # exact equality
    pf4, u4, y4, x04 = lattice_case(N_MAIN, 200, dev)
    args = pf_scan.scan_inputs(pf4, u4, y4)
    kw = dict(N=N_MAIN, thresh=float(pf4.resample_threshold), seed=SEED,
              noise="none", x0=x04)
    llk, nk = (float(v) for v in pf_scan.pf_loglik_scan(*args, **kw))
    llp, npl = (float(v) for v in pf_scan.pf_loglik_scan_plain(*args, **kw))
    require(llk == llp and nk == npl and 1 <= npl < 200,
            f"A lattice: {llk} vs {llp}, {nk} vs {npl}")
    log("A case iv", f"noise none, lattice, threshold 1-0.5/N: kernel {llk} "
        f"plain {llp} resamples {nk}/{npl} (exact: 0/1 weights, sums "
        f"exact in any order)")
    # times at the main path's shape
    u, y, ll_kf = data(T_MAIN)
    uc, yc = u.float().to(dev), y.float().to(dev)
    pf = model(N_MAIN)
    args = pf_scan.scan_inputs(pf, uc, yc)
    kw = dict(N=N_MAIN, thresh=THRESH, seed=SEED)
    nres = float(pf_scan.pf_loglik_scan(*args, **kw)[1])
    ops_a = (N_MAIN * T_MAIN * pf_step_ops(2, 2)
             + pf_resample_ops(N_MAIN, nres, 2))
    bytes_a = sum(a.numel() * a.element_size() for a in args
                  if isinstance(a, torch.Tensor)) + 8
    stats["pf_loglik_scan"] = dict(
        max_abs_err=worst, library_ms=None,  # no PyTorch call filters
        **bound(bytes_a, ops_a),
        ms=cuda_ms(lambda: pf_scan.pf_loglik_scan(*args, **kw), 5),
        plain_ms=cuda_ms(lambda: pf_scan.pf_loglik_scan_plain(*args, **kw),
                         1))
    log("A pf_loglik_scan", f"N={N_MAIN} T={T_MAIN}: {stats['pf_loglik_scan']}")

    # ---- 4. main path -----------------------------------------------------
    for k in kernels:
        k.launches = 0
    g = torch.Generator(device=dev).manual_seed(SEED)
    ll = float(pf.loglik(uc, yc, generator=g))
    route = llpt.last_route()
    require(route == "cuda_fused_scan", f"route {route}")
    require(pf_scan.PF_LOGLIK_SCAN.launches == 1,
            f"kernel A launched {pf_scan.PF_LOGLIK_SCAN.launches} times")
    rel = abs(ll - ll_kf) / abs(ll_kf)
    require(rel < 0.01, f"PF ll {ll} within 1% of KF ll {ll_kf}")
    log("main", f"pf.loglik N={N_MAIN} T={T_MAIN}: ll {ll} KF {ll_kf} "
        f"rel {rel:.3g}; route {route}; kernel A launches 1")

    # ---- 5. unfused path --------------------------------------------------
    T5 = 100
    pfk = model(N_MAIN, backend="kernel")
    u5, y5, ll_kf5 = data(T5, seed=5)
    sol = pfk.forward_trajectory(u5.float().to(dev), y5.float().to(dev),
                                 generator=torch.Generator(device=dev)
                                 .manual_seed(SEED))
    rel5 = abs(float(sol.ll) - ll_kf5) / abs(ll_kf5)
    require(rel5 < 0.01, f"forward_trajectory ll {float(sol.ll)} within 1% "
            f"of KF {ll_kf5}")
    slice1 = kernels[:4]
    launches.update({k.name: k.launches for k in slice1})
    log("unfused", f"forward_trajectory N={N_MAIN} T={T5} kernel noise: ll "
        f"{float(sol.ll)} KF {ll_kf5} rel {rel5:.3g}; launches "
        f"{ {k.name: k.launches for k in slice1} }")
    for k in slice1:
        require(k.launches >= 1, f"kernel {k.name} launched in the main run")
        require(k.name != "pf_loglik_scan" or k.launches == 1,
                "kernel A launched once")
    # two seeded calls agree bit for bit, resampling included; PyTorch's
    # 1-D cumsum on the card (CUB's single-pass scan) is what did not
    again = pfk.forward_trajectory(u5.float().to(dev), y5.float().to(dev),
                                   generator=torch.Generator(device=dev)
                                   .manual_seed(SEED))
    require(all(torch.equal(getattr(sol, f), getattr(again, f))
                for f in ("x", "w", "we", "ll")),
            "two seeded forward_trajectory calls are bitwise equal")
    we_ = torch.rand(N_MAIN, generator=gcpu).to(dev) ** 8
    distinct = {name: len({fn(we_).cpu().numpy().tobytes()
                           for _ in range(50)})
                for name, fn in (("torch.cumsum", lambda w: torch.cumsum(
                    w, 0)), ("ops.resample._cumsum", ors._cumsum))}
    require(distinct["ops.resample._cumsum"] == 1,
            f"the resampling cumsum has one order: {distinct}")
    log("unfused", f"two seeded calls bitwise equal; distinct results of 50 "
        f"cumsums of {N_MAIN} weights: {distinct}")

    # main-path time: median of 5 calls after a warm-up, host clock
    def run():
        out = pf.loglik(uc, yc, generator=g)
        torch.cuda.synchronize()
        return out

    run()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    log("main", f"median of 5: {med * 1e3:.3f} ms, "
        f"{N_MAIN * T_MAIN / med:.4g} particle-steps/s ({smi})")

    # N = 1e6, T = 200
    u6, y6, ll_kf6 = data(200, seed=6)
    pf6 = model(1_000_000)
    t0 = time.perf_counter()
    ll6 = float(pf6.loglik(u6.float().to(dev), y6.float().to(dev),
                           generator=g))
    dt6 = time.perf_counter() - t0
    rel6 = abs(ll6 - ll_kf6) / abs(ll_kf6)
    require(llpt.last_route() == "cuda_fused_scan" and rel6 < 0.01,
            f"N=1e6: ll {ll6} within 1% of KF {ll_kf6}")
    log("main", f"N=1e6 T=200: ll {ll6} KF {ll_kf6} rel {rel6:.3g}; one "
        f"call {dt6 * 1e3:.1f} ms incl. admission")

    # ---- 6. the KF bank ---------------------------------------------------
    kf32 = convert.kalman_filter_from_numpy(A, B, C, 0, R1, R2,
                                            dtype=torch.float32, device=dev)

    def bank_data(Bk, seed):
        """Bk trajectories of the model, simulated in f64 on the CPU."""
        g = torch.Generator().manual_seed(seed)
        At, Bt, Ct = (torch.tensor(M, dtype=torch.float64) for M in (A, B, C))
        L1c = torch.linalg.cholesky(torch.tensor(R1, dtype=torch.float64))
        L2c = torch.linalg.cholesky(torch.tensor(R2, dtype=torch.float64))
        us = torch.full((Bk, T_BANK, 1), 0.3, dtype=torch.float64)
        x = torch.randn(Bk, 2, generator=g, dtype=torch.float64) @ L1c.T
        ys = []
        for t in range(T_BANK):
            ys.append(x @ Ct.T + torch.randn(Bk, 2, generator=g,
                                              dtype=torch.float64) @ L2c.T)
            x = x @ At.T + us[:, t] @ Bt.T + torch.randn(
                Bk, 2, generator=g, dtype=torch.float64) @ L1c.T
        return us, torch.stack(ys, 1)

    banks = {Bk: bank_data(Bk, 60 + i) for i, Bk in enumerate((1024, 8192))}
    # F against its twin on the card, B = 1024: rtol 2e-5, atol 1e-4 (f32;
    # the kernel contracts multiply-adds the twin rounds separately)
    us64, ys64 = banks[1024]
    usb, ysb = us64.float().to(dev), ys64.float().to(dev)
    _, Sch, Kg, _, Am, Bm, Cm, Dm = tbank._shared_recursion(
        kf32, T_BANK, torch.float32, dev)
    scal, _ = bank_scan.bank_scalars(Sch, Kg, Am, Bm, Cm, Dm, 1)
    x0 = kf32.d0.mean.float().contiguous()
    llf = bank_scan.bank_loglik_scan(scal, ysb, usb, x0, 2, 2, 1)
    llp = bank_scan.bank_loglik_scan_plain(scal, ysb, usb, x0, 2, 2, 1)
    require(torch.allclose(llf, llp, rtol=2e-5, atol=1e-4),
            "bank kernel F within rtol 2e-5, atol 1e-4 of its twin")
    Bk, S = ysb.shape[0], scal.shape[1]
    stats["bank_loglik"] = dict(
        max_abs_err=float((llf - llp).abs().max()),
        ms=cuda_ms(lambda: bank_scan.bank_loglik_scan(scal, ysb, usb, x0, 2,
                                                      2, 1), 50),
        plain_ms=cuda_ms(lambda: bank_scan.bank_loglik_scan_plain(
            scal, ysb, usb, x0, 2, 2, 1), 1),
        library_ms=None,  # a T-step recursion: no one PyTorch call
        # per member-step: Z 2ny(ny + nu + nx), dll 3ny, x 2nx(nx + ny + nu)
        **bound(4 * (Bk * T_BANK * 3 + T_BANK * S + 2 + Bk),
                Bk * T_BANK * (2 * 2 * 5 + 6 + 1 + 2 * 2 * 5)))
    elems_b = temporal._filter_elements_p(
        *(temporal._m_split(M) if M.ndim == 3 else temporal._v_split(M)
          for M in (Am, torch.zeros(T_BANK, 2, device=dev), Cm,
                    kf32.R1.expand(T_BANK, 2, 2), kf32.R2.expand(T_BANK, 2, 2),
                    torch.zeros(T_BANK, 2, device=dev))),
        torch.zeros(2, device=dev), kf32.d0.cov, T_BANK)
    x_b = torch.stack(temporal._leaves(elems_b), -1)
    k_bank_ms = cuda_ms(lambda: assoc_scan.plane_scan(x_b, 2,
                                                      assoc_scan.FILTER), 50)
    log("F bank_loglik", f"B={Bk} T={T_BANK}: {stats['bank_loglik']}; "
        f"kernel K on the bank's T={T_BANK} elements {k_bank_ms:.4f} ms")

    # the bank's main path: one K and one F launch a call
    for k in kernels:
        k.launches = 0
    lls = {}
    for Bk, (us64, ys64) in banks.items():
        k0, f0 = assoc_scan.ASSOC_SCAN.launches, bank_scan.BANK_LOGLIK.launches
        lls[Bk] = llpt.kf_bank_loglik(kf32, us64.float().to(dev),
                                      ys64.float().to(dev))
        route = llpt.last_route("kf_bank_loglik")
        require(route == "cuda_bank_kernel", f"bank route {route}")
        require(assoc_scan.ASSOC_SCAN.launches == k0 + 1
                and bank_scan.BANK_LOGLIK.launches == f0 + 1,
                f"B={Bk}: one K and one F launch")
    bank_path = {k.name: k.launches for k in kernels}
    require(bank_path["bank_loglik"] == 2 and bank_path["assoc_scan"] == 2
            and sum(bank_path.values()) == 4,
            f"bank path launches {bank_path}")
    # agreement: the f64 CPU plane path for every member, and the
    # sequential loglik for 8 members, rtol 1e-4
    for Bk, (us64, ys64) in banks.items():
        oracle = tbank.kf_bank_loglik(kf, us64, ys64, method="plane")
        got = lls[Bk].double().cpu()
        rel = float(((got - oracle).abs() / oracle.abs()).max())
        require(rel < 1e-4, f"B={Bk}: bank ll within 1e-4 of the f64 "
                f"plane path (got {rel:.3g})")
        seq = torch.stack([llpt.loglik(kf, us64[b], ys64[b],
                                       method="sequential")
                           for b in range(8)])
        rel8 = float(((got[:8] - seq).abs() / seq.abs()).max())
        require(rel8 < 1e-4, f"B={Bk}: 8 members within 1e-4 of the "
                f"sequential f64 loglik (got {rel8:.3g})")
        usc, ysc = us64.float().to(dev), ys64.float().to(dev)
        med = host_median_ms(lambda: llpt.kf_bank_loglik(kf32, usc, ysc))
        log("bank", f"kf_bank_loglik B={Bk} T={T_BANK}: ll[0] "
            f"{float(got[0]):.6f}, max rel vs f64 plane {rel:.3g}, vs "
            f"sequential (8) {rel8:.3g}; route cuda_bank_kernel; median of "
            f"5 {med:.3f} ms, {Bk / med * 1e3:.4g} passes/s ({smi})")
    log("bank", f"launches {bank_path}")

    # ---- 7. the temporal-parallel KF and RTS -------------------------------
    def par_data(T, seed=7):
        g = torch.Generator().manual_seed(seed)
        return (torch.full((T, 1), 0.3, dtype=torch.float64),
                0.3 * torch.randn(T, 2, generator=g, dtype=torch.float64))

    u7, y7 = par_data(T_PAR)
    u7c, y7c = u7.float().to(dev), y7.float().to(dev)
    F7, c7 = temporal._affine_model(kf32, u7c, T_PAR, y7c)
    ms_ = [temporal._m_split(M) for M in (
        F7, temporal._resolve_seq(kf32.C, T_PAR),
        temporal._resolve_seq(kf32.R1, T_PAR),
        temporal._resolve_seq(kf32.R2, T_PAR))]
    elems_f = temporal._filter_elements_p(
        ms_[0], temporal._v_split(c7), ms_[1], ms_[2], ms_[3],
        temporal._v_split(y7c), kf32.d0.mean, kf32.d0.cov, T_PAR)
    # K against its twin on the same elements, rtol 2e-4, atol 2e-5 (f32
    # in another association order), filter then smooth
    worst = 0.0
    got_f = assoc_scan.filter_scan_p(elems_f)
    ref_f = assoc_scan.filter_scan_p_plain(elems_f)
    elems_s = temporal._smooth_elements_p(ms_[0], temporal._v_split(c7),
                                          ms_[2], *got_f, T_PAR)
    got_s = assoc_scan.smooth_scan_p(elems_s)
    ref_s = assoc_scan.smooth_scan_p_plain(elems_s)
    for what, got, ref in (("filter", got_f, ref_f),
                           ("smooth", got_s, ref_s)):
        (gm, gM), (rm, rM) = ((temporal._v_join(m), temporal._m_join(M))
                              for m, M in (got, ref))
        require(torch.allclose(gm, rm, rtol=2e-4, atol=2e-5)
                and torch.allclose(gM, rM, rtol=2e-4, atol=2e-5),
                f"kernel K {what} within rtol 2e-4, atol 2e-5 of its twin")
        worst = max(worst, float((gm - rm).abs().max()),
                    float((gM - rM).abs().max()))
    x_f = torch.stack(temporal._leaves(elems_f), -1)
    E = x_f.shape[1]
    ops_k = scan_combines(T_PAR) * combine_ops(
        temporal._filter_combine_soa,
        (("m", 2), ("v", 2), ("m", 2), ("v", 2), ("m", 2)))
    stats["assoc_scan"] = dict(
        max_abs_err=worst,
        ms=cuda_ms(lambda: assoc_scan.plane_scan(x_f, 2, assoc_scan.FILTER),
                   50),
        plain_ms=cuda_ms(lambda: assoc_scan.filter_scan_p_plain(elems_f), 3),
        library_ms=None,  # PyTorch has no associative scan of a custom op
        **bound(4 * T_PAR * (E + 6), ops_k))
    smooth_ms = cuda_ms(lambda: assoc_scan.plane_scan(
        torch.stack(temporal._leaves(elems_s), -1), 2, assoc_scan.SMOOTH),
        50)
    log("K assoc_scan", f"filter T={T_PAR}: {stats['assoc_scan']}; smooth "
        f"scan {smooth_ms:.4f} ms (with its stacking copy); "
        f"{ops_k // scan_combines(T_PAR)} operations a filter combine, "
        f"{scan_combines(T_PAR)} combines")

    # the temporal-parallel main path
    for k in kernels:
        k.launches = 0
    ll7 = float(llpt.loglik(kf32, u7c, y7c))
    route = llpt.last_route("loglik")
    require(route == "cuda_temporal_parallel", f"loglik route {route}")
    sol7 = llpt.forward_trajectory(kf32, u7c, y7c)
    require(sol7.route == "cuda_temporal_parallel",
            f"forward_trajectory route {sol7.route}")
    sm7 = llpt.parallel_rts_smooth(kf32, u7c, y7c)
    par_path = {k.name: k.launches for k in kernels}
    require(par_path["assoc_scan"] == 4 and sum(par_path.values()) == 4,
            f"temporal-parallel launches {par_path}")
    require(bool(torch.isfinite(sm7.xT).all()) and sm7.xT.shape
            == (T_PAR, 2), "smoothed states finite, [T, 2]")
    ll7_ref = float(llpt.loglik(kf, u7, y7, method="parallel"))
    rel7 = abs(ll7 - ll7_ref) / abs(ll7_ref)
    require(rel7 < 1e-4, f"T={T_PAR}: ll {ll7} within 1e-4 of the f64 CPU "
            f"plain route {ll7_ref}")
    # T = 2000 against the sequential f64 KF and the f64 CPU smoother
    u2k, y2k = par_data(2000, seed=8)
    seq = llpt.forward_trajectory(kf, u2k, y2k, method="sequential")
    par = llpt.forward_trajectory(kf32, u2k.float().to(dev),
                                  y2k.float().to(dev))
    require(par.route == "cuda_temporal_parallel", "T=2000 route")
    tol = dict(rtol=1e-3, atol=1e-4)
    require(abs(float(par.ll) - float(seq.ll)) < 1e-4 * abs(float(seq.ll))
            and torch.allclose(par.xt.double().cpu(), seq.xt, **tol)
            and torch.allclose(par.Rt.double().cpu(), seq.Rt, **tol),
            "T=2000: ll, xt, Rt agree with the sequential f64 KF")
    smc = llpt.parallel_rts_smooth(kf32, u2k.float().to(dev),
                                   y2k.float().to(dev))
    smr = llpt.parallel_rts_smooth(kf, u2k, y2k)
    require(torch.allclose(smc.xT.double().cpu(), smr.xT, **tol)
            and torch.allclose(smc.RT.double().cpu(), smr.RT, **tol),
            "T=2000: xT, RT agree with the f64 CPU smoother")
    med7 = host_median_ms(lambda: llpt.loglik(kf32, u7c, y7c))
    log("parallel", f"loglik T={T_PAR}: ll {ll7} f64 CPU {ll7_ref} rel "
        f"{rel7:.3g}; T=2000 ll {float(par.ll)} vs sequential "
        f"{float(seq.ll)}; median of 5 {med7:.3f} ms, "
        f"{T_PAR / med7 * 1e3:.4g} steps/s ({smi})")
    u6m, y6m = par_data(1_000_000, seed=9)
    t0 = time.perf_counter()
    ll6m = float(llpt.loglik(kf32, u6m.float().to(dev), y6m.float().to(dev)))
    dt6m = time.perf_counter() - t0
    route = llpt.last_route()
    ll6m_ref = float(llpt.loglik(kf, u6m, y6m, method="parallel"))
    rel6m = abs(ll6m - ll6m_ref) / abs(ll6m_ref)
    require(route == "cuda_temporal_parallel" and rel6m < 1e-4,
            f"T=1e6: route {route}, ll {ll6m} within 1e-4 of the f64 CPU "
            f"route {ll6m_ref}")
    log("parallel", f"loglik T=1e6: ll {ll6m} f64 CPU {ll6m_ref} rel "
        f"{rel6m:.3g}; one call {dt6m * 1e3:.1f} ms; launches {par_path}")
    launches["bank_loglik"] = bank_path["bank_loglik"]
    launches["assoc_scan"] = bank_path["assoc_scan"] + par_path["assoc_scan"]


    whole_scan_phases(dev, kernels, stats, launches, smi)
    ffbs_phase(dev, kernels, stats, launches, smi, data, model, kf)
    smoother_phase(dev, kernels, stats, launches, smi, A, B, C, R1, R2)
    tracking_phases(dev, kernels, stats, launches, smi, data, model, kf,
                    lattice_case)
    log("done", f"all phases in {time.perf_counter() - t_start:.1f} s, the "
        f"build included")

    print(json.dumps({"kernels": [dict(
        name=k.name, route="cuda", source=k.source, replaces=k.replaces,
        launches=launches[k.name], **stats[k.name]) for k in kernels]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
