#!/usr/bin/env python3
"""Where the time of the port's PF, KF-bank, temporal-parallel,
whole-scan UKF/EKF and smoothing calls goes.

    python3 scripts/torch_stage_breakdown.py [pf] [bank] [parallel] [scan]
                                             [smooth] [track] [paramest]

Needs one CUDA card.  Runs the named sections (all without arguments),
in f32:

- ``pf``: ``pf.loglik`` at N = 1e5 and 1e6, T = 1000 (bench.py:389-420),
- ``bank``: ``kf_bank_loglik`` at B = 1024 and 8192, T = 200
  (bench.py:423-469),
- ``parallel``: ``loglik`` (temporal-parallel) at T = 1e5
  (bench.py:724-736), all three on the benchmark's 2-state model;
- ``scan``: the whole-scan kernels at T = 5e4: ``kf.loglik_fused`` on the
  4-state CV model (kernel H), ``loglik`` of the nonlinear EKF (kernel I)
  and of the quadtank UKF (kernel G), stages: the callbacks' trace and
  library build (once, at first use), the admission probes, the drives,
  the constants, the kernel with its wrapper;
- ``smooth``: the FFBS particle smoother ``pf.smooth`` at M = N = 1000,
  T = 500 on the benchmark's 2-state model (bench.py:548-564), stages:
  the forward pass, the terminal draw, the predicted means, the
  whitening, kernel J with its wrapper; and the iterated UKF smoother
  ``parallel_ukf_smooth`` on the quadtank model at T = 5e4
  (bench.py:695-721) with iters = 1 and 4 (the difference over 3 is one
  refinement iteration), stages of one iteration: the unscented SLR,
  the filtered moments (elements and kernel K), the smoothing scan;
- ``track``: ``mean_trajectory(pf, u, y, generator=g)`` and
  ``pf_stats_fused`` at N = 1e5, T = 1000 on the benchmark's 2-state
  model, stages: the admission (probes and coefficients), the inputs,
  the seed draw, kernel A's moments mode with its wrapper;
- ``paramest``: a PMMH iteration's parts, each θ building a new filter:
  on the PF at N = 1e5, T = 1000 the admission of a new filter and
  kernel A with its wrapper; on the KF at T = 200 ``loglik`` of a new
  filter (kernel H and its admission) against a second call on the same
  filter (the verdict kept); ``ukf_bank_loglik`` of the affine UKF at
  B = 1024, T = 200 against its static walk and ``kf_bank_loglik`` of
  the equivalent KF; and the LM residuals of ``autotune_covariances``
  at T = 1000 (4 parameters): one pass, their Jacobian by
  ``torch.func.jacfwd`` and by ``torch.func.jacrev``, on the card in
  float32 and on the host in float64 (one call each after a warm-up at
  T = 50; not in the default set: about 80 s);

first as whole calls, then stage by stage through the same internal
functions in the verb's order.  Each time is the median of 7 (host
clock, synchronize after the call or stage).  A profiled run of each
whole call gives the device time summed over its kernels and the number
of kernel launches.  Prints one line per measurement and, last, the
card's ``nvidia-smi`` name and power limit.
"""
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

A = [[0.97043, -0.097368], [0.097368, 0.970437]]
B, C = [[0.1], [0.0]], [[1.0, 0.0], [0.0, 1.0]]
R1 = [[0.01, 0.0], [0.0, 0.01]]
R2 = [[0.1, 0.0], [0.0, 0.1]]


def median_ms(fn, reps=7):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def events_ms(fn, reps):
    """Mean ms per call of ``fn`` by CUDA events, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def sm_clock() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def device_profile(fn, reps=3):
    """(device ms per call summed over kernels, kernel launches per call,
    {kernel name: device ms per call} for the port's own kernels) from
    torch.profiler; (None, None, {}) when it records no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # acc_events: keep the events of every call.  The device events are
    # divided by reps, so a profile that lost calls reads low; compare a
    # kernel's figure here with its time by CUDA events
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kern:
        return None, None, {}
    busy_us = sum(e.time_range.elapsed_us() for e in kern)
    own = {}
    for e in kern:
        m = re.search(r"(reduce_kernel|apply_kernel|bank_loglik_kernel|"
                      r"pf_scan_kernel|akf_scan_kernel|ekf_scan_kernel|"
                      r"ukf_scan_kernel|ffbs_backward_kernel)", e.name)
        if m:
            own[m.group(0)] = (own.get(m.group(0), 0.0)
                               + e.time_range.elapsed_us() / 1e3 / reps)
    return busy_us / 1e3 / reps, len(kern) / reps, own


def whole_scan_section(dev, line):
    """Stages of the whole-scan calls (kernels H, I, G) at T = 5e4."""
    import lowlevelparticlefilters_jl_tpu_torch as llpt
    from lowlevelparticlefilters_jl_tpu_torch import convert, routing
    from lowlevelparticlefilters_jl_tpu_torch.kernels import ukf_scan as k

    T = 50_000
    g = torch.Generator().manual_seed(1)
    cv_a = [[1, 0, 0.1, 0], [0, 1, 0, 0.1], [0, 0, 1, 0], [0, 0, 0, 1]]
    cv_c = [[1, 0, 0, 0], [0, 1, 0, 0]]
    A = torch.tensor(cv_a, dtype=torch.float32, device=dev)
    C = torch.tensor(cv_c, dtype=torch.float32, device=dev)
    y = torch.randn(T, 2, generator=g).to(dev)
    kf = convert.kalman_filter_from_numpy(cv_a, None, cv_c, 0,
                                          [[0.1 * (i == j) for j in range(4)]
                                           for i in range(4)],
                                          [[1.0, 0.0], [0.0, 1.0]],
                                          dtype=torch.float32, device=dev)
    ekf = llpt.make_ekf(lambda x, u, p, t: A @ x + 0.01 * torch.sin(x),
                        lambda x, u, p, t: C @ x, kf.R1, kf.R2,
                        d0=llpt.MvNormal(torch.zeros(4, device=dev),
                                         0.5 * kf.R1 / 0.1), nu=0, ny=2)

    def g1(x):
        return torch.sqrt(torch.abs(x) + 0.1)

    ukf = llpt.make_ukf(
        lambda x, u, p, t: x + 0.1 * torch.stack(
            [-g1(x[0]) + 0.5 * g1(x[1]), -0.5 * g1(x[1]) + 0.1]),
        lambda x, u, p, t: x, 1e-3 * torch.eye(2, device=dev),
        1e-2 * torch.eye(2, device=dev), ny=2, nu=0,
        d0=llpt.MvNormal(torch.ones(2, device=dev),
                         0.1 * torch.eye(2, device=dev)))
    yq = 1.0 + 0.1 * y

    def once(what, fn):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        line(f"{what} (first use, once)", (time.perf_counter() - t0) * 1e3)

    once(f"scan T={T} EKF trace (make_fx + lowering)",
         lambda: k._ekf_programs(ekf, 0, dev))
    once(f"scan T={T} EKF callback library build",
         lambda: k._ekf_programs(ekf, 0, dev).library())
    once(f"scan T={T} UKF trace (make_fx + lowering)",
         lambda: k._ukf_programs(ukf, 0, dev))
    once(f"scan T={T} UKF callback library build",
         lambda: k._ukf_programs(ukf, 0, dev).library())
    for tag, call in (
            (f"H kf.loglik_fused T={T}", lambda: kf.loglik_fused(y)),
            (f"I EKF loglik T={T}", lambda: llpt.loglik(ekf, None, y)),
            (f"G UKF loglik T={T}", lambda: llpt.loglik(ukf, None, yq))):
        line(f"{tag} whole call", median_ms(call))
        busy, n, own = device_profile(call)
        print(f"{tag} device busy {busy} ms/call, {n} kernel launches/call;"
              f" kernels: {own}", flush=True)
    for tag, f in (("H", kf), ("I", ekf), ("G", ukf)):
        fresh = f.replace()  # the same filter, with no verdict kept yet
        once(f"scan T={T} {tag} admission verdict (static walk + probes)",
             lambda: k.affinity(fresh, 0))
    v = k.affinity(kf, 0)
    st = {}

    def h_drives():
        st["d"] = k.live_drives(*k.drives(v.ekf, None, T, dev))

    def h_kernel():
        k.akf_scan(y, *st["d"], *k._gaussian_inputs(v.ekf, dev), *v.AC, 1.0)

    comp_e = k._ekf_programs(ekf, 0, dev)
    comp_u = k._ukf_programs(ukf, 0, dev)
    for name, fn in (
            ("H cached verdict", lambda: k.affinity(kf, 0)),
            ("H drives (two vmapped callbacks, zero check)", h_drives),
            ("H kernel incl. wrapper", h_kernel),
            ("I cached verdict", lambda: k.affinity(ekf, 0)),
            ("I parallel-route check (_affine_equiv_kf)",
             lambda: routing._affine_equiv_kf(ekf, None, y)),
            ("I cached programs and constants",
             lambda: k._ekf_programs(ekf, 0, dev).consts(dev)),
            ("I kernel incl. wrapper", lambda: k.ekf_scan(ekf, y)),
            ("G cached verdict", lambda: k.affinity(ukf, 0)),
            ("G cached programs and constants",
             lambda: k._ukf_programs(ukf, 0, dev).consts(dev)),
            ("G kernel incl. wrapper", lambda: k.ukf_scan(ukf, yq))):
        line(f"scan T={T} {name}", median_ms(fn))
    print(f"scan H drives read: {[d is not None for d in st['d']]}",
          flush=True)
    sizes = [[len(p.instrs) for _, p in c.progs] for c in (comp_e, comp_u)]
    print(f"scan callback programs (instructions): I {sizes[0]}, G "
          f"{sizes[1]}", flush=True)


def smooth_section(dev, line):
    """Stages of the FFBS smoother (kernel J) and of the iterated UKF
    smoother (kernel K)."""
    import lowlevelparticlefilters_jl_tpu_torch as llpt
    from lowlevelparticlefilters_jl_tpu_torch import convert
    from lowlevelparticlefilters_jl_tpu_torch.kernels import ffbs
    from lowlevelparticlefilters_jl_tpu_torch.models.sigmapoints import (
        ukf_weights)
    from lowlevelparticlefilters_jl_tpu_torch.ops.resample import resample
    from lowlevelparticlefilters_jl_tpu_torch.parallel import temporal as tp
    from lowlevelparticlefilters_jl_tpu_torch.routing import (
        seed_from_generator)
    from lowlevelparticlefilters_jl_tpu_torch.smoothing import (
        _predicted_means)

    def profiled(tag, fn):
        busy, n, own = device_profile(fn)
        print(f"{tag} device busy {busy} ms/call, {n} kernel launches/call;"
              f" kernels: {own}", flush=True)
        return n

    N = M = 1000
    T = 500
    kf64 = convert.kalman_filter_from_numpy(A, B, C, 0, R1, R2, device="cpu")
    _, u64, y64 = llpt.simulate(kf64, torch.full((T, 1), 0.3,
                                                 dtype=torch.float64),
                                torch.Generator().manual_seed(2))
    u, y = u64.float().to(dev), y64.float().to(dev)
    pf = convert.particle_filter_from_numpy(
        N, *convert.linear_callbacks(A, B, C, device=dev), R1, R2, R1,
        resample_threshold=0.1, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    tag = f"ffbs N={N} M={M} T={T}"
    whole = lambda: pf.smooth(u, y, M=M, generator=gen)  # noqa: E731
    line(f"{tag} whole pf.smooth", median_ms(whole))
    profiled(tag, whole)
    st = {}
    d1 = pf.dynamics_density
    tvec = torch.arange(T - 1, dtype=torch.float32, device=dev)

    def forward():
        st["sol"] = pf.forward_trajectory(u, y, generator=gen)

    def terminal():
        sol = st["sol"]
        st["xb_T"] = sol.x[-1][resample(sol.we[-1], gen, M)]

    def predicted():
        sol = st["sol"]
        st["xpred"] = _predicted_means(pf.dynamics, sol.x[:-1], sol.u[:-1],
                                       tvec, None)

    def whiten():
        st["w"] = ffbs.whiten(st["xpred"], st["sol"].w[:-1], d1.chol())

    def kernel_j():
        zpred, wfc, c, Linv = st["w"]
        ffbs.ffbs_backward_scan(zpred, wfc, c, st["sol"].x[:-1].contiguous(),
                                st["xb_T"].contiguous(), Linv,
                                d1.mean.contiguous(),
                                seed_from_generator(gen))

    for name, fn in (("forward pass (pf.forward_trajectory)", forward),
                     ("terminal draw (resample + gather)", terminal),
                     ("predicted means (vmapped dynamics)", predicted),
                     ("whitening and centring", whiten),
                     ("kernel J incl. wrapper and seed draw", kernel_j)):
        line(f"{tag} {name}", median_ms(fn))
    profiled(f"{tag} kernel J alone", kernel_j)
    # J by CUDA events over short and long runs of back-to-back launches,
    # the SM clock read beside each
    zpred, wfc, c, Linv = st["w"]
    args = (zpred, wfc, c, st["sol"].x[:-1].contiguous(),
            st["xb_T"].contiguous(), Linv, d1.mean.contiguous(), 7)
    for reps in (5, 100, 5):
        clk = sm_clock()
        print(f"{tag} kernel J by CUDA events over {reps} launches: "
              f"{events_ms(lambda: ffbs.ffbs_backward_scan(*args), reps):.4f}"
              f" ms/launch; SM clock before {clk}, after {sm_clock()}",
              flush=True)

    T = 50_000
    g1 = lambda x: torch.sqrt(torch.abs(x) + 0.1)  # noqa: E731
    ukf = llpt.make_ukf(
        lambda x, u, p, t: x + 0.1 * torch.stack(
            [-g1(x[0]) + 0.5 * g1(x[1]), -0.5 * g1(x[1]) + 0.1]),
        lambda x, u, p, t: x, 1e-3 * torch.eye(2, device=dev),
        1e-2 * torch.eye(2, device=dev), ny=2, nu=0,
        d0=llpt.MvNormal(torch.ones(2, device=dev),
                         0.1 * torch.eye(2, device=dev)))
    yq = (1.0 + 0.1 * torch.randn(T, 2, generator=torch.Generator()
                                  .manual_seed(3))).to(dev)
    tag = f"iterated UKF smoother T={T}"
    ms, launches = {}, {}
    for iters in (1, 4):
        call = lambda: tp.parallel_ukf_smooth(  # noqa: E731
            ukf, None, yq, iters=iters)
        ms[iters] = median_ms(call)
        line(f"{tag} iters={iters} whole call", ms[iters])
        launches[iters] = profiled(f"{tag} iters={iters}", call)
    line(f"{tag} one refinement iteration ((iters 4 - iters 1) / 3)",
         (ms[4] - ms[1]) / 3)
    if launches[1] is not None:
        print(f"{tag} launches per refinement iteration "
              f"{(launches[4] - launches[1]) / 3}", flush=True)
    nx = ny = 2
    W = ukf_weights(ukf.weight_params, nx)
    utv = torch.zeros(T, 0, device=dev)
    tvec = torch.arange(T, dtype=torch.float32, device=dev)
    m0, P0 = ukf.d0.mean, ukf.d0.cov
    Qp = tp._m_split(tp._resolve_seq(ukf.R1, T))
    Rp = tp._m_split(tp._resolve_seq(ukf.measurement_model.R2, T))
    st = {"xb": tuple(m0[i].expand(T) for i in range(nx)),
          "Pb": tuple(tuple(P0[i, j].expand(T) for j in range(nx))
                      for i in range(nx))}

    def slr():
        (Fd, cd, Omf), (Fh, dh, Omh) = tp._slr_linearize_p(
            (ukf.dynamics, ukf.measurement_model.measurement), (nx, ny),
            st["xb"], st["Pb"], W, utv, tvec, None, T)
        st["lin"] = (Fd, cd, tp._madd_p(Qp, Omf), Fh, tp._madd_p(Rp, Omh),
                     tp._vsub_p(tp._v_split(yq), dh))

    def filtered():
        F, c, Qe, H, Re, ye = st["lin"]
        st["f"] = tp._filtered_moments_pp(F, c, H, Qe, Re, ye, m0, P0, T)

    def smoothed():
        F, c, Qe = st["lin"][:3]
        tp._parallel_smooth_core_p(F, c, Qe, *st["f"], T)

    for name, fn in (("unscented SLR (_slr_linearize_p)", slr),
                     ("filtered moments (elements + kernel K)", filtered),
                     ("smoothing elements + kernel K", smoothed)):
        line(f"{tag} one iteration: {name}", median_ms(fn))
        profiled(f"{tag} one iteration: {name}", fn)


def paramest_section(dev, line):
    """The ``paramest`` section (see the module doc)."""
    import lowlevelparticlefilters_jl_tpu_torch as llpt
    from lowlevelparticlefilters_jl_tpu_torch import convert
    from lowlevelparticlefilters_jl_tpu_torch.kernels import pf_scan
    from lowlevelparticlefilters_jl_tpu_torch.parallel.temporal import (
        _callback_affine_in_x)

    g = torch.Generator().manual_seed(3)
    scales = iter((1.0 + 0.001 * torch.arange(1, 1000)).tolist())

    def kf_at(s, T, dtype=torch.float32, device=dev):
        R2s = [[s * v for v in r] for r in R2]
        return convert.kalman_filter_from_numpy(A, B, C, 0, R1, R2s,
                                                dtype=dtype, device=device)

    # PMMH on the PF: a new filter's admission, then kernel A
    T = 1000
    u = torch.full((T, 1), 0.3, device=dev)
    y = (0.3 * torch.randn(T, 2, generator=g)).to(dev)
    f, gcb = convert.linear_callbacks(A, B, C, device=dev)

    def pf_at(s):
        R2s = [[s * v for v in r] for r in R2]
        return convert.particle_filter_from_numpy(
            100_000, f, gcb, R1, R2s, R1, resample_threshold=0.1,
            device=dev)

    coef = pf_scan.kernel_admits(pf_at(1.0), u, y)
    line("paramest PF N=1e5 T=1000: a new filter's kernel_admits",
         median_ms(lambda: pf_scan.kernel_admits(pf_at(next(scales)), u,
                                                 y)))
    pf = pf_at(1.0)
    line("paramest PF: kernel A with its wrapper (coefficients given)",
         median_ms(lambda: pf_scan.pf_loglik_fused(pf, u, y, 7,
                                                   coef=coef)))
    # PMMH on the KF at T = 200: kernel H with and without the admission
    uh, yh = u[:200], y[:200]
    line("paramest KF T=200: loglik of a new filter (H and admission)",
         median_ms(lambda: llpt.loglik(kf_at(next(scales), 200), uh, yh)))
    kfh = kf_at(1.0, 200)
    line("paramest KF T=200: loglik of the same filter (verdict kept)",
         median_ms(lambda: llpt.loglik(kfh, uh, yh)))
    # the affine UKF bank: the whole call, its walk, the KF bank
    Bk = 1024
    ub = torch.full((200, 1), 0.3, device=dev)
    ys = (0.3 * torch.randn(Bk, 200, 2, generator=g)).to(dev)
    kfb = kf_at(1.0, 200)
    ukf = llpt.make_ukf(f, gcb, kfb.R1, kfb.R2, nu=1, ny=2)
    line(f"paramest ukf_bank_loglik B={Bk} T=200 (whole call)",
         median_ms(lambda: llpt.ukf_bank_loglik(ukf, ub, ys)))
    zu0 = torch.zeros(0, device=dev)
    line("paramest ukf_bank_loglik: the static walk of both callbacks",
         median_ms(lambda: [_callback_affine_in_x(
             lambda z, uu, p, t, fn=fn: fn(z[:2], z[2:], p, t), 3, zu0,
             None, 0.0) for fn in (f, gcb)]))
    line("paramest ukf_bank_loglik: kf_bank_loglik of the equivalent KF",
         median_ms(lambda: llpt.kf_bank_loglik(kfb, ub, ys)))
    # the LM residuals and their Jacobian
    for where, dtype, device in (("card f32", torch.float32, dev),
                                 ("host f64", torch.float64, "cpu")):
        for T in (50, 1000):
            kf0 = kf_at(0.05, T, dtype, device)
            uT = torch.full((T, 1), 0.3, dtype=dtype, device=device)
            yT = (0.3 * torch.randn(T, 2, generator=g)).to(dtype).to(device)
            th = torch.log(torch.tensor([0.01, 0.01, 0.005, 0.005],
                                        dtype=dtype, device=device))

            def res(t_, kf0=kf0, uT=uT, yT=yT):
                fr = llpt.reconstruct_filter(
                    kf0, torch.diag(torch.exp(t_[:2])),
                    torch.diag(torch.exp(t_[2:])))
                return llpt.prediction_errors(fr, uT, yT, loglik=True,
                                              offset=5.0)

            for name, fn in (("residuals", lambda: res(th)),
                             ("jacfwd", lambda: torch.func.jacfwd(res)(th)),
                             ("jacrev", lambda: torch.func.jacrev(res)(th))):
                t0 = time.perf_counter()
                fn()
                if device != "cpu":
                    torch.cuda.synchronize()
                if T == 1000:
                    line(f"paramest LM T={T} {where}: {name} (one call)",
                         (time.perf_counter() - t0) * 1e3)


def main():
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import lowlevelparticlefilters_jl_tpu_torch as llpt
    from lowlevelparticlefilters_jl_tpu_torch import convert
    from lowlevelparticlefilters_jl_tpu_torch.filters import bank as tbank
    from lowlevelparticlefilters_jl_tpu_torch.kernels import bank_scan
    from lowlevelparticlefilters_jl_tpu_torch.parallel import temporal as tp

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    sections = set(sys.argv[1:]) or {"pf", "bank", "parallel", "scan",
                                     "smooth", "track"}
    kf = convert.kalman_filter_from_numpy(A, B, C, 0, R1, R2,
                                          dtype=torch.float32, device=dev)
    g = torch.Generator().manual_seed(0)

    def line(what, ms):
        print(f"{what}: {ms:.3f} ms", flush=True)

    from lowlevelparticlefilters_jl_tpu_torch.kernels import pf_scan
    from lowlevelparticlefilters_jl_tpu_torch.routing import (
        seed_from_generator)

    T = 1000
    u = torch.full((T, 1), 0.3, device=dev)
    y = (0.3 * torch.randn(T, 2, generator=g)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    for N in (100_000, 1_000_000) if "pf" in sections else ():
        pf = convert.particle_filter_from_numpy(
            N, *convert.linear_callbacks(A, B, C, device=dev), R1, R2, R1,
            resample_threshold=0.1, device=dev)
        tag = f"pf N={N} T={T}"
        line(f"{tag} whole pf.loglik",
             median_ms(lambda: pf.loglik(u, y, generator=gen)))
        busy, n, own = device_profile(
            lambda: pf.loglik(u, y, generator=gen))
        print(f"{tag} device busy {busy} ms/call, {n} kernel launches/call;"
              f" kernel A: {own}", flush=True)
        st = {}

        def admits():
            st["coef"] = pf_scan.kernel_admits(pf, u, y)

        def inputs():
            st["args"] = pf_scan.scan_inputs(pf, u, y, st["coef"])

        def seed():
            st["seed"] = seed_from_generator(gen)

        def kernel_a():
            pf_scan.pf_loglik_scan(*st["args"], N=N, thresh=0.1,
                                   seed=st["seed"])

        for name, fn in (("kernel_admits (probes + coefficients)", admits),
                         ("scan_inputs", inputs), ("seed draw", seed),
                         ("kernel A incl. wrapper", kernel_a)):
            line(f"{tag} {name}", median_ms(fn))

    if "track" in sections:
        N = 100_000
        pf = convert.particle_filter_from_numpy(
            N, *convert.linear_callbacks(A, B, C, device=dev), R1, R2, R1,
            resample_threshold=0.1, device=dev)
        tag = f"track N={N} T={T}"
        for what, call in (
                ("mean_trajectory", lambda: llpt.mean_trajectory(
                    pf, u, y, generator=gen)),
                ("pf_stats_fused", lambda: llpt.pf_stats_fused(
                    pf, u, y, seed_from_generator(gen)))):
            line(f"{tag} whole {what}", median_ms(call))
            busy, n, own = device_profile(call)
            print(f"{tag} {what} device busy {busy} ms/call, {n} kernel "
                  f"launches/call; kernel A: {own}", flush=True)
        st = {}

        def admits():
            st["coef"] = pf_scan.kernel_admits(pf, u, y)

        def inputs():
            st["args"] = pf_scan.scan_inputs(pf, u, y, st["coef"])

        def seed():
            st["seed"] = seed_from_generator(gen)

        def moments(want):
            return lambda: pf_scan.pf_scan(*st["args"], N=N, thresh=0.1,
                                           seed=st["seed"], moments=want)

        for name, fn in (("kernel_admits (probes + coefficients)", admits),
                         ("scan_inputs", inputs), ("seed draw", seed),
                         ("kernel A means mode incl. wrapper", moments(1)),
                         ("kernel A stats mode incl. wrapper", moments(2))):
            line(f"{tag} {name}", median_ms(fn))
        for want in (1, 2):
            line(f"{tag} kernel A moments={want} by CUDA events",
                 events_ms(moments(want), 10))

    for Bk in (1024, 8192) if "bank" in sections else ():
        T = 200
        us = torch.full((Bk, T, 1), 0.3, device=dev)
        ys = torch.randn(Bk, T, 2, generator=g).to(dev)
        tag = f"bank B={Bk} T={T}"
        line(f"{tag} whole kf_bank_loglik",
             median_ms(lambda: llpt.kf_bank_loglik(kf, us, ys)))
        busy, n, own = device_profile(
            lambda: llpt.kf_bank_loglik(kf, us, ys))
        print(f"{tag} device busy {busy} ms/call, {n} kernel launches/call;"
              f" kernels F, K: {own}", flush=True)
        st = {}

        def resolve():
            st["m"] = [tbank._resolve_stacked(M, T, n_, m_, torch.float32,
                                              dev)
                       for M, n_, m_ in ((kf.A, 2, 2), (kf.B, 2, 1),
                                         (kf.C, 2, 2), (kf.D, 2, 1),
                                         (kf.R1, 2, 2), (kf.R2, 2, 2))]

        def elements():
            Am, _, Cm, _, Q, R = st["m"]
            z = torch.zeros(T, 2, device=dev)
            st["el"] = tp._filter_elements_p(
                tp._m_split(Am), tp._v_split(z), tp._m_split(Cm),
                tp._m_split(Q), tp._m_split(R), tp._v_split(z),
                torch.zeros(2, device=dev), kf.d0.cov, T)

        def scan():
            st["xt"], st["Ct"] = tp._scan_filter_p(st["el"])

        def full_core():
            Am, _, Cm, _, Q, R = st["m"]
            z = torch.zeros(T, 2, device=dev)
            st["core"] = tp._parallel_filter_core_p(
                Am, z, Cm, Q, R, z, torch.zeros(2, device=dev), kf.d0.cov)

        def scalars():
            Schp, Kp = st["core"][6], st["core"][7]
            Am, Bm, Cm, Dm, _, _ = st["m"]
            st["sc"] = bank_scan.bank_scalars(
                tp._m_join(Schp), tp._m_join(Kp), Am, Bm, Cm, Dm, 1)

        def kernel_f():
            bank_scan.bank_loglik_scan(st["sc"][0], ys, us,
                                       kf.d0.mean.contiguous(), 2, 2, 1)

        for name, fn in (("resolve the matrices", resolve),
                         ("plane elements (_filter_elements_p)", elements),
                         ("kernel K scan incl. stacking", scan),
                         ("whole _parallel_filter_core_p", full_core),
                         ("bank_scalars (f64)", scalars),
                         ("kernel F incl. wrapper", kernel_f)):
            line(f"{tag} {name}", median_ms(fn))

    T = 100_000
    u = torch.full((T, 1), 0.3, device=dev)
    y = (0.3 * torch.randn(T, 2, generator=g)).to(dev)
    tag = f"parallel T={T}"
    if "parallel" in sections:
        line(f"{tag} whole loglik",
             median_ms(lambda: llpt.loglik(kf, u, y)))
        busy, n, own = device_profile(lambda: llpt.loglik(kf, u, y))
        print(f"{tag} device busy {busy} ms/call, {n} kernel launches/call;"
              f" kernel K: {own}", flush=True)
    st = {}

    def model():
        F, c = tp._affine_model(kf, u, T, y)
        st["m"] = (F, c, tp._resolve_seq(kf.C, T), tp._resolve_seq(kf.R1, T),
                   tp._resolve_seq(kf.R2, T))

    def elements():
        F, c, H, Q, R = st["m"]
        st["el"] = tp._filter_elements_p(
            tp._m_split(F), tp._v_split(c), tp._m_split(H), tp._m_split(Q),
            tp._m_split(R), tp._v_split(y), kf.d0.mean, kf.d0.cov, T)

    def scan():
        st["xt"], st["Ct"] = tp._scan_filter_p(st["el"])

    def core():
        F, c, H, Q, R = st["m"]
        st["core"] = tp._parallel_filter_core_p(F, c, H, Q, R, y, kf.d0.mean,
                                                kf.d0.cov)

    for name, fn in (("affine model and stacks", model),
                     ("plane elements (_filter_elements_p)", elements),
                     ("kernel K scan incl. stacking", scan),
                     ("whole _parallel_filter_core_p", core)):
        if "parallel" in sections:
            line(f"{tag} {name}", median_ms(fn))
    if "scan" in sections:
        whole_scan_section(dev, line)
    if "smooth" in sections:
        smooth_section(dev, line)
    if "paramest" in sections:
        paramest_section(dev, line)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
