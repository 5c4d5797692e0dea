#!/usr/bin/env python3
"""Where the time of the port's KF bank and temporal-parallel calls goes.

    python3 scripts/torch_stage_breakdown.py

Needs one CUDA card.  Runs, on the benchmark's 2-state model in f32:

- ``pf.loglik`` at N = 1e5 and 1e6, T = 1000 (bench.py:389-420),
- ``kf_bank_loglik`` at B = 1024 and 8192, T = 200 (bench.py:423-469),
- ``loglik`` (temporal-parallel) at T = 1e5 (bench.py:724-736),

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


def device_profile(fn, reps=3):
    """(device ms per call summed over kernels, kernel launches per call,
    {kernel name: device ms per call} for the port's own kernels) from
    torch.profiler; (None, None, {}) when it records no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
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
                      r"pf_scan_kernel)", e.name)
        if m:
            own[m.group(0)] = (own.get(m.group(0), 0.0)
                               + e.time_range.elapsed_us() / 1e3 / reps)
    return busy_us / 1e3 / reps, len(kern) / reps, own


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
    for N in (100_000, 1_000_000):
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

    for Bk in (1024, 8192):
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
    line(f"{tag} whole loglik", median_ms(lambda: llpt.loglik(kf, u, y)))
    busy, n, own = device_profile(lambda: llpt.loglik(kf, u, y))
    print(f"{tag} device busy {busy} ms/call, {n} kernel launches/call; "
          f"kernel K: {own}", flush=True)
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
        line(f"{tag} {name}", median_ms(fn))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
