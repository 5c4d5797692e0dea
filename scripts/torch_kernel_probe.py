#!/usr/bin/env python3
"""Probe kernels C (normal draws), G, H, I (whole scans), A (the
bootstrap PF in one launch), D (the PF's propagate step), E and B (the
systematic resample), K (the temporal-parallel scans), J (the FFBS
backward pass) and F (the KF bank) on the card: device time against host
time, the compiled step loops, A's time a step, the cost of a grid sync,
H's prefix and tail, D's step, E's resample, K's launches, J's step, B's
gather and F's scan.

    python3 scripts/torch_kernel_probe.py [noise] [scan] [pf] [sync] [akf] [prop]
        [resample] [kscan] [ffbs] [gather] [bank] [--out DIR]

Needs one CUDA card.  Runs the named sections (all without arguments).
It reads the kernels of the checkout it lies in, so a copy of it in
another checkout (the parent commit, with ``kernels/sass.py`` copied
beside its kernels for ``scan``) measures that tree: run both in one call
to compare two trees on one card.  ``chip_smoke.py`` measures its own
tree only, and reads neither G's nor H's step loop.

- ``noise``: kernel C (``kernels/noise.normal``) and ``torch.randn`` at
  2e5 and 2e6 normals: the mean time a call by CUDA events over 50
  back-to-back calls (``chip_smoke.py``'s clock) and, in turns, the median
  of ten such runs of 100 calls; the device time of the kernel alone by
  ``torch.profiler`` and the host time of one call (the enqueue, no
  synchronize; median of 400);
- ``scan``: kernel I on ``A x + 0.01 sin x`` (forward-mode and user
  Jacobians), G on the quadtank UKF and H on the CV KF at T = 5e4: the
  time a call by CUDA events, the SM clock while the kernel runs, cycles
  a step, and the step loop of each compiled kernel read from
  ``cuobjdump -sass`` (``kernels/sass.py``: instructions, basic blocks,
  loads from device and local memory, the dependent chain; I and G,
  whose callbacks build a library of their own).  The SASS goes to
  ``DIR`` (default ``probe_out/`` in the checkout, gitignored), gzipped.
  G also at nx = 8 (17 sigma points) on ``nx8_ukf`` below;
- ``pf``: kernel A on the benchmark's 2-state model (bench.py:389-402)
  at N = 1e5, T = 1000: loglik mode at Neff thresholds 0.1 (the main
  path), 0 (never resamples) and 1 (always), so a step's cost splits into
  the step without a resample and the resample's own; the moments (means
  and covariances), segment and scalar-density modes at 0.1; N = 1e6,
  T = 200 at 0.1; the grid of each launch.  Mean ms a call by CUDA events
  over 5 calls, and microseconds a step;
- ``sync``: a kernel of empty ``grid.sync()`` rounds (and rounds that
  also read every block's partial, as A's grid-wide sums do) at A's grids
  at N = 1e5 and 1e6 and at 132 x 1024: microseconds a sync, A's sync
  floor.  Needs ``llpf_grid_sync_probe`` (this tree's ``csrc/pf_scan.cu``);
- ``akf``: kernel H at T = 5e4 on the CV KF with R1 = 0.1 I and with
  R1 = 1e-4 I (G close to 1), ll and trajectory: ms a call by CUDA events
  (20 calls), the SM clock, cycles a step; where the tree's H reports
  them (``akf_scan(..., stats=)``), the freeze step t_f and thread 0's
  ``clock64`` cycles in the serial prefix and the parallel tail; the
  host-clock median of ``kf.loglik_fused``;
- ``prop``: the bootstrap PF's predict step with ``noise_backend=
  "kernel"`` (kernel D) on the benchmark's model at N = 1e5 and 1000: the
  host-clock median ms of a step (with a synchronize; 200 steps) and,
  by ``torch.profiler``, its launches and host synchronizations; then
  ``forward_trajectory`` at N = 1e5, T = 100 (``chip_smoke.py`` phase 5)
  and ``pf.smooth`` at N = M = 1000, T = 500 (phase 11), host-clock
  medians of 5 and 3 calls, with launches and synchronizations a step;
- ``resample``: the exact systematic resample (``fused_systematic_gather``,
  kernel E's route), the default one (``resample_systematic_gather``,
  kernel B's) and the slot boundaries alone (``ops.resample.
  _systematic_slots``) at N = 1e5, nx = 2, float32: the host-clock median
  ms of a call with a synchronize (200 calls), ms by CUDA events (50 back
  to back), launches and host synchronizations a call and each device
  kernel's time by ``torch.profiler``;
- ``kscan``: kernel K's three modes (filter, smooth, whole elements) at
  T = 1e5 and 1e6, nx = 2, on generic elements: ms a call by CUDA events
  (20 calls), each launch of one call in order with its device time
  (``torch.profiler``), and whether two calls give the same bits;
- ``ffbs``: kernel J (``ffbs.ffbs_backward_scan``) on whitened random
  clouds at M = 1000, nx = 2, (N, T) = (1000, 500) and (65536, 24), with
  noise (the draw ``pf.smooth`` takes) and without (MAP): ms a call by
  CUDA events (5 back to back), launches and device ms by
  ``torch.profiler``; where the tree's J reports them (``stats=``), block
  0's first warp's ``clock64`` split of the step loop (``ffbs.CLOCKS``);
- ``gather``: kernel B (``resample_route.systematic_gather``) given the
  same slot boundaries K (float64 ``torch.cumsum`` of the weights, the
  slot formula and the running max, formed in this script so that any
  tree gets them) at N = 1e5 (device ms by ``torch.profiler``, 50 calls;
  the events are host-bound there) and at N = 2^24 + 1 and 2^25 (ms by
  CUDA events, 20 back to back), nx = 2, float32, uniform and U^20
  weights; whether the rows equal the plain gather bitwise, and the
  share of the bytes bound N (4 + 2 * 4 nx) B at 3.35 TB/s; then at
  N = 1e5 and 2^25, U^20, float32 and float64 rows, the copy of a row as
  one vector against the copy word by word (the rows one element off
  alignment), in turns;
- ``bank``: kernel F (``bank_scan.bank_loglik_scan``) on the benchmark's
  bank model (nx = ny = 2, a per-member input, nu = 1, float32) at
  (B, T) = (1024, 200), (8192, 2000), (256, 1e4), and at odd T and
  T = 2 mod 4, (8192, 2001) and (8192, 2002), where members' rows start
  off a 16-byte boundary: ms a call by CUDA events (back to back),
  device ms by ``torch.profiler``, the bytes bound 4 B T (ny + nu) +
  4 T S bytes at 3.35 TB/s and its share, the largest difference from
  the tree's own twin at B = 1024; the host-clock median of
  ``kf_bank_loglik`` (20 calls with a synchronize) at B = 1024 and 8192;
  where the tree's F reports them (``stats=``), block 0's first warp's
  ``clock64`` split (``bank_scan.CLOCKS``) with one member a warp.

Prints one line per measurement and, last, the card's ``nvidia-smi`` name
and power limit.
"""
import gzip
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]


def events_ms(fn, reps):
    """Mean ms a call of ``fn`` by CUDA events over ``reps`` back-to-back
    calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def host_us(fn, reps=400):
    """Median host microseconds of one call of ``fn`` (no synchronize:
    the enqueue), synchronizing every 50 calls so the queue stays short."""
    fn()
    torch.cuda.synchronize()
    times = []
    for i in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
        if i % 50 == 49:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    return statistics.median(times) * 1e6


def traced(fn, reps=1):
    """torch.profiler's events (CPU and CUDA) of ``reps`` calls of ``fn``
    and a synchronize, after a warm-up call and one warm-up step of the
    profiler's own schedule (a trace that starts cold now and then misses
    its first kernels), without the schedule's own step annotation
    (``ProfilerStep#``, on the device timeline too)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 acc_events=True) as prof:
        for _ in range(2):
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            prof.step()
    return [e for e in prof.events() if not e.name.startswith("ProfilerStep")]


def device_kernels_ms(fn, reps=20):
    """{kernel name: device ms a call} by torch.profiler."""
    out: dict = {}
    for e in traced(fn, reps):
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out[e.name[:60]] = (out.get(e.name[:60], 0.0)
                                + e.time_range.elapsed_us() / 1e3 / reps)
    return out


def clock_while(fn):
    """The mean ms a call of ``fn`` by CUDA events (5 calls), and the SM
    clock (MHz) that ``nvidia-smi`` reads while at least 0.6 s of queued
    calls run."""
    ms = events_ms(fn, 5)
    for _ in range(max(5, math.ceil(600 / ms))):
        fn()
    seen = smi("clocks.sm").split()[0]
    torch.cuda.synchronize()
    return (float(seen) if seen.isdigit() else float("nan")), ms


def _profile_counts(fn):
    """(device kernels, synchronize calls, device-to-host copies) of one
    call of ``fn`` and the closing synchronize, by torch.profiler."""
    from torch.autograd import DeviceType

    ev = traced(fn)
    dev_ev = [e.name for e in ev if e.device_type == DeviceType.CUDA]
    kern = sum(1 for n in dev_ev if not n.startswith(("Memcpy", "Memset")))
    dtoh = sum(1 for n in dev_ev if "DtoH" in n)
    syncs = sum(1 for e in ev if e.device_type == DeviceType.CPU
                and e.name in ("cudaStreamSynchronize",
                               "cudaDeviceSynchronize"))
    return kern, syncs, dtoh


def step_counts(fn, steps):
    """Device kernels, ``cudaStreamSynchronize``/``cudaDeviceSynchronize``
    calls and device-to-host copies a step of one call of ``fn`` over
    ``steps`` steps, by torch.profiler; the synchronizations less those of
    an empty call under the same profiler (its closing ones)."""
    kern, syncs, dtoh = _profile_counts(fn)
    syncs -= _profile_counts(lambda: None)[1]
    return (f"{kern / steps:.2f} launches, {syncs / steps:.2f} syncs, "
            f"{dtoh / steps:.2f} DtoH copies a step")


def host_ms(fn, reps):
    """Median host ms of ``fn`` with a synchronize, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def akf_section(dev):
    """Kernel H's prefix and tail (see the module doc)."""
    import inspect

    import chip_smoke as cs
    from lowlevelparticlefilters_jl_tpu_torch import convert
    from lowlevelparticlefilters_jl_tpu_torch.kernels import ukf_scan as k

    T = 50_000
    y = torch.randn(T, 2, generator=torch.Generator().manual_seed(80)).to(dev)
    has_stats = "stats" in inspect.signature(k.akf_scan).parameters
    for r1 in (0.1, 1e-4):
        kf = convert.kalman_filter_from_numpy(
            cs.CV_A, None, cs.CV_C, 0,
            [[r1 * (i == j) for j in range(4)] for i in range(4)],
            [[1.0, 0.0], [0.0, 1.0]], dtype=torch.float32, device=dev)
        v = k.affinity(kf, 0)
        d = k.live_drives(*k.drives(v.ekf, None, T, dev))
        hin = (y, *d, *k._gaussian_inputs(v.ekf, dev), *v.AC, 1.0)
        for traj in (False, True):
            mhz, ms = clock_while(lambda: k.akf_scan(*hin, traj=traj))
            line = (f"akf R1={r1} traj={traj} T={T}: {ms:.4f} ms a call by "
                    f"CUDA events, SM clock {mhz} MHz, "
                    f"{ms * 1e-3 * mhz * 1e6 / T:.1f} cycles a step")
            if has_stats:
                st = torch.zeros(6, dtype=torch.int64, device=dev)
                k.akf_scan(*hin, traj=traj, stats=st)
                tf, pre, tail, p1, scan, p2 = st.tolist()
                line += (f"; t_f {tf}, prefix {pre} cycles ({pre / mhz:.2f} "
                         f"us, {pre / max(tf, 1):.0f} a step), tail {tail} "
                         f"cycles ({tail / mhz:.2f} us, "
                         f"{tail / max(T - tf, 1):.2f} a step: pass 1 {p1}, "
                         f"scan {scan}, pass 2 {p2})")
            print(line, flush=True)
        print(f"akf R1={r1}: kf.loglik_fused host median of 20 "
              f"{host_ms(lambda: kf.loglik_fused(y), 20):.4f} ms", flush=True)


def prop_section(dev):
    """Kernel D's predict step and the unfused paths (module doc)."""
    import lowlevelparticlefilters_jl_tpu_torch as llpt
    from lowlevelparticlefilters_jl_tpu_torch import convert

    A = [[0.97043, -0.097368], [0.097368, 0.970437]]
    B, C = [[0.1], [0.0]], [[1.0, 0.0], [0.0, 1.0]]
    R1 = [[0.01, 0.0], [0.0, 0.01]]
    R2 = [[0.1, 0.0], [0.0, 0.1]]
    kf = convert.kalman_filter_from_numpy(A, B, C, 0, R1, R2, device="cpu")

    def model(N):
        f, g = convert.linear_callbacks(A, B, C, device=dev)
        return convert.particle_filter_from_numpy(
            N, f, g, R1, R2, R1, noise_backend="kernel", device=dev)

    def data(T, seed):
        u = torch.full((T, 1), 0.3, dtype=torch.float64)
        _, u, y = llpt.simulate(kf, u, torch.Generator().manual_seed(seed))
        return u.float().to(dev), y.float().to(dev)

    u1 = torch.full((1,), 0.3, device=dev)
    for N in (100_000, 1000):
        pf = model(N)
        st = pf.init(torch.Generator(device=dev).manual_seed(0))
        step = lambda: pf.predict(st, u1)  # noqa: E731
        print(f"prop predict N={N}: host median of 200 "
              f"{host_ms(step, 200):.4f} ms a step; {step_counts(step, 1)}; "
              f"route {llpt.routing.last_route('predict')}", flush=True)
    pf = model(100_000)
    u, y = data(100, 5)
    fwd = lambda: pf.forward_trajectory(  # noqa: E731
        u, y, generator=torch.Generator(device=dev).manual_seed(0))
    print(f"prop forward_trajectory N=1e5 T=100: host median of 5 "
          f"{host_ms(fwd, 5):.3f} ms; {step_counts(fwd, 100)}", flush=True)
    pf = model(1000)
    u, y = data(500, 610)
    sm = lambda: pf.smooth(  # noqa: E731
        u, y, M=1000, generator=torch.Generator(device=dev).manual_seed(0))
    print(f"prop pf.smooth N=M=1000 T=500: host median of 3 "
          f"{host_ms(sm, 3):.3f} ms; {step_counts(sm, 500)}", flush=True)


def noise_section(dev):
    from lowlevelparticlefilters_jl_tpu_torch.kernels import _lib, noise

    _lib.library()
    for n in (200_000, 2_000_000):
        shape = (n // 2, 2)
        c_call = lambda: noise.normal(7, shape, tag=noise.TAG_INIT,  # noqa
                                      device=dev)
        r_call = lambda: torch.randn(shape, device=dev)  # noqa: E731
        for tag, fn in (("C normal", c_call), ("torch.randn", r_call)):
            ev = events_ms(fn, 50)
            dk = device_kernels_ms(fn)
            print(f"noise n={n} {tag}: {ev:.5f} ms a call by CUDA events "
                  f"(50 back to back); host {host_us(fn):.2f} us a call "
                  f"(enqueue, median of 400); device kernels {dk}",
                  flush=True)
        rounds = ([], [])
        for _ in range(5):
            for k, fn_ in ((0, c_call), (1, r_call), (1, r_call),
                           (0, c_call)):
                rounds[k].append(events_ms(fn_, 100))
        print(f"noise n={n} in turns, 10 x 100 calls each by CUDA events: "
              f"C median {statistics.median(rounds[0]):.5f} ms, "
              f"torch.randn median {statistics.median(rounds[1]):.5f} ms",
              flush=True)


def scan_section(dev, out: Path):
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from lowlevelparticlefilters_jl_tpu_torch import convert
    from lowlevelparticlefilters_jl_tpu_torch.kernels import sass
    from lowlevelparticlefilters_jl_tpu_torch.kernels import ukf_scan as k

    out.mkdir(parents=True, exist_ok=True)
    T = 50_000
    g = torch.Generator().manual_seed(90)
    y = torch.randn(T, 2, generator=g).to(dev)
    yq = (1.0 + 0.1 * torch.randn(T, 2, generator=g)).to(dev)
    kf = convert.kalman_filter_from_numpy(cs.CV_A, None, cs.CV_C, 0,
                                          [[0.1 * (i == j) for j in range(4)]
                                           for i in range(4)],
                                          [[1.0, 0.0], [0.0, 1.0]],
                                          dtype=torch.float32, device=dev)
    v = k.affinity(kf, 0)
    d = k.live_drives(*k.drives(v.ekf, None, T, dev))
    hin = (y, *d, *k._gaussian_inputs(v.ekf, dev), *v.AC, 1.0)
    cases = [
        ("I", "ekf_scan_kernel", cs.nonlinear_ekf(dev, torch.float32),
         k._ekf_programs, k.ekf_scan, y),
        ("I user Jacobians", "ekf_scan_kernel",
         cs.nonlinear_ekf(dev, torch.float32, True), k._ekf_programs,
         k.ekf_scan, y),
        ("G quadtank", "ukf_scan_kernel", cs.quadtank_ukf(dev, torch.float32),
         k._ukf_programs, k.ukf_scan, yq)]
    for tag, kname, f, programs, scan, ys in cases:
        comp = programs(f, 0, dev)
        text = sass.disassemble(comp.library()._name)
        with gzip.open(out / f"{tag.replace(' ', '_')}.sass.gz", "wt") as fh:
            fh.write(text)
        for trajectory in (False, True):
            mhz, ms = clock_while(lambda: scan(f, ys, traj=trajectory))
            try:
                loop = sass.step_loop(text, kname, trajectory)
            except Exception as exc:  # the listing is saved beside
                loop = f"not read: {exc!r}"
            print(f"scan {tag} traj={trajectory} T={T}: {ms:.3f} ms a call "
                  f"by CUDA events, SM clock {mhz} MHz, "
                  f"{ms * 1e-3 * mhz * 1e6 / T:.0f} cycles a step; step "
                  f"loop {loop}", flush=True)
    mhz, ms = clock_while(lambda: k.akf_scan(*hin))
    print(f"scan H T={T}: {ms:.3f} ms a call by CUDA events, SM clock {mhz} "
          f"MHz, {ms * 1e-3 * mhz * 1e6 / T:.0f} cycles a step", flush=True)
    if hasattr(k, "ukf_layout"):
        ukf_layouts(dev, out, T, yq, y)


def ukf_layouts(dev, out: Path, T, yq, y):
    """Kernel G in both sigma-point layouts (kernels/ukf_scan.ukf_layout)
    at nx = 2 (quadtank), 4 (the CV UKF) and 8 (``chip_smoke.nx8_ukf``),
    the trajectory off: ms a call, cycles a step, the step loop."""
    import chip_smoke as cs
    from lowlevelparticlefilters_jl_tpu_torch.kernels import sass
    from lowlevelparticlefilters_jl_tpu_torch.kernels import ukf_scan as k

    y4 = torch.randn(T, 4, generator=torch.Generator().manual_seed(91))
    keep = k.UKF_THREAD_MAX_NX
    try:
        for nx, make, ys in ((2, cs.quadtank_ukf, yq), (4, cs.cv_ukf, y),
                             (8, cs.nx8_ukf, y4.to(dev))):
            for layout in ("thread", "warp"):
                k.UKF_THREAD_MAX_NX = 8 if layout == "thread" else 0
                f = make(dev, torch.float32)  # a new filter: a new build
                comp = k._ukf_programs(f, 0, dev)
                text = sass.disassemble(comp.library()._name)
                name = f"G_nx{nx}_{layout}.sass.gz"
                with gzip.open(out / name, "wt") as fh:
                    fh.write(text)
                mhz, ms = clock_while(lambda: k.ukf_scan(f, ys))
                try:
                    loop = sass.step_loop(text, "ukf_scan_kernel", False)
                except Exception as exc:  # the listing is saved beside
                    loop = f"not read: {exc!r}"
                print(f"G layout nx={nx} {layout} T={T}: {ms:.3f} ms a call "
                      f"by CUDA events, SM clock {mhz} MHz, "
                      f"{ms * 1e-3 * mhz * 1e6 / T:.0f} cycles a step; step "
                      f"loop {loop}", flush=True)
    finally:
        k.UKF_THREAD_MAX_NX = keep


def pf_section(dev):
    """Kernel A's modes on the benchmark's model (see the module doc)."""
    import lowlevelparticlefilters_jl_tpu_torch as llpt
    from lowlevelparticlefilters_jl_tpu_torch import convert
    from lowlevelparticlefilters_jl_tpu_torch.kernels import pf_scan

    A = [[0.97043, -0.097368], [0.097368, 0.970437]]
    B, C = [[0.1], [0.0]], [[1.0, 0.0], [0.0, 1.0]]
    R1, R2 = [[0.01, 0.0], [0.0, 0.01]], [[0.1, 0.0], [0.0, 0.1]]
    kf = convert.kalman_filter_from_numpy(A, B, C, 0, R1, R2, device="cpu")

    def case(N, T, thresh, seed=1, dens=False):
        u = torch.full((T, 1), 0.3, dtype=torch.float64)
        _, u, y = llpt.simulate(kf, u, torch.Generator().manual_seed(seed))
        f, g = convert.linear_callbacks(A, B, C, device=dev)
        pf = convert.particle_filter_from_numpy(
            N, f, g, R1, R2, R1, resample_threshold=thresh, device=dev)
        if dens:
            pf = pf.replace(measurement_density=llpt.TupleProduct(
                [llpt.StudentT(4.0, 0.0, 0.3), llpt.Laplace(0.0, 0.25)]))
        args = pf_scan.scan_inputs(pf, u.float().to(dev), y.float().to(dev))
        return args, dict(N=N, thresh=thresh, seed=0,
                          dens=pf_scan.scan_density(pf, dev))

    def run(tag, args, kw, T, N):
        out = pf_scan.pf_scan(*args, **kw)
        ms = events_ms(lambda: pf_scan.pf_scan(*args, **kw), 5)
        line = (f"pf {tag} N={N} T={T}: {ms:.4f} ms a call by CUDA events "
                f"(5 calls), {ms * 1e3 / T:.3f} us a step; resamples "
                f"{float(out['nres']):g}; ll {float(out['ll']):.6g}")
        if hasattr(pf_scan, "pf_scan_phase_cycles"):
            ph = pf_scan.pf_scan_phase_cycles(*args, **kw)
            grid = ph.pop("grid")
            tot = sum(ph.values())
            line += (f"; grid {grid} x 512; block 0's cycles a step by "
                     "phase " + ", ".join(f"{k} {v / T:.0f}"
                                          for k, v in ph.items())
                     + f" (sum {tot / T:.0f})")
        print(line, flush=True)
        return ms

    import re

    from lowlevelparticlefilters_jl_tpu_torch.kernels import _lib

    name = None  # ptxas lines of the build, when this process built it
    for line in _lib.library().log.splitlines():
        m = re.search(r"Compiling entry function '(\S*pf_scan_kernel\S*)'",
                      line)
        if m:
            name = m.group(1)
        if name and ("spill" in line or "Used" in line):
            print(f"pf build {name}: {line.strip()}", flush=True)
            name = None if "Used" in line else name
    N, T = 100_000, 1000
    ms = {}
    for thresh in (0.1, 0.0, 1.0):
        args, kw = case(N, T, thresh)
        ms[thresh] = run(f"loglik thresh={thresh}", args, kw, T, N)
    args, kw = case(N, T, 0.1)
    run("moments=1", args, dict(kw, moments=1), T, N)
    run("moments=2", args, dict(kw, moments=2), T, N)
    x0 = torch.randn(N, 2, generator=torch.Generator().manual_seed(3)
                     ).to(dev)
    w0 = torch.full((N,), -math.log(N), device=dev)
    run("segment", args, dict(kw, x0=x0, w0=w0, segment=True), T, N)
    argsd, kwd = case(N, T, 0.1, dens=True)
    run("density", argsd, kwd, T, N)
    print(f"pf split N={N} T={T}: a step without a resample "
          f"{ms[0.0] * 1e3 / T:.3f} us, with one {ms[1.0] * 1e3 / T:.3f} us "
          f"(the resample's own {(ms[1.0] - ms[0.0]) * 1e3 / T:.3f} us)",
          flush=True)
    args6, kw6 = case(1_000_000, 200, 0.1, seed=6)
    run("loglik thresh=0.1", args6, kw6, 200, 1_000_000)


def sync_section(dev):
    """Microseconds a grid.sync() (and a sync with its partial read) at
    kernel A's grids and at 132 x 1024 (see the module doc)."""
    from lowlevelparticlefilters_jl_tpu_torch.kernels import _lib

    lib = _lib.library().lib
    out = torch.zeros(1, dtype=torch.int32)
    shapes = []
    for N in (100_000, 1_000_000):
        _lib.check(lib.llpf_pf_scan_grid(N, 0, 2, 2, out.data_ptr()), "grid")
        shapes.append((f"A's grid at N={N}, nx = ny = 2", int(out[0]), 512))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    shapes += [("391 x 256 (256-thread blocks at N=1e5)", 391, 256),
               (f"{sms} x 1024", sms, 1024)]
    iters = 20_000
    for tag, G, threads in shapes:
        part = torch.zeros(2 * G, device=dev)
        for reads in (0, 1):
            def call():
                _lib.check(lib.llpf_grid_sync_probe(
                    part.data_ptr(), G, threads, iters, reads,
                    _lib.stream_ptr(part)), "grid_sync_probe")
            us = events_ms(call, 3) * 1e3 / iters
            print(f"sync {tag} ({G} x {threads}), partial read {reads}: "
                  f"{us:.4f} us a round", flush=True)


def launch_list(fn):
    """[(kernel name, device ms)] of one call of ``fn`` in launch order,
    by torch.profiler (``traced``)."""
    ev = [e for e in traced(fn)
          if e.device_type == torch.autograd.DeviceType.CUDA]
    ev.sort(key=lambda e: e.time_range.start)
    return [(e.name[:48], round(e.time_range.elapsed_us() / 1e3, 5))
            for e in ev]


def resample_section(dev):
    """The exact and default systematic resamples (module doc)."""
    from lowlevelparticlefilters_jl_tpu_torch.kernels import _lib, resample_v2
    from lowlevelparticlefilters_jl_tpu_torch.ops import resample as ors

    _lib.library()
    N = 100_000
    g = torch.Generator().manual_seed(100)
    x = torch.randn(N, 2, generator=g).to(dev)
    we = torch.rand(N, generator=g) ** 8
    we = (we / we.sum()).to(dev)
    r = torch.rand((), generator=g).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    calls = (("E exact (fused_systematic_gather)",
              lambda: resample_v2.fused_systematic_gather(x, we, gen)),
             ("B default (resample_systematic_gather)",
              lambda: ors.resample_systematic_gather(x, we, gen)),
             ("slots (_systematic_slots)",
              lambda: ors._systematic_slots(we, r, N)))
    if hasattr(resample_v2, "systematic_resample"):
        calls += (("E kernel alone (systematic_resample)",
                   lambda: resample_v2.systematic_resample(x, we, r)),)
    if hasattr(resample_v2, "STAMPS"):
        # E's phases: block 0's clock64 at its phase boundaries (cycles
        # from the previous stamp), the median of 20 calls
        for tag, fn in (("E", lambda st: resample_v2.systematic_resample(
                x, we, r, stats=st)), ("slot stage", lambda st:
                resample_v2.systematic_slots(we, r, N, stats=st))):
            rows = []
            for _ in range(21):
                st = torch.zeros(len(resample_v2.STAMPS), dtype=torch.int64,
                                 device=dev)
                fn(st)
                rows.append(st.diff().tolist())
            med = [statistics.median(c) for c in zip(*rows[1:])]
            print(f"resample {tag} phases (block 0's cycles, median of 20): "
                  f"{dict(zip(resample_v2.STAMPS[1:], med))}, total "
                  f"{sum(med)}", flush=True)
    for tag, fn in calls:
        print(f"resample {tag} N={N} nx=2 f32: host median of 200 "
              f"{host_ms(fn, 200):.4f} ms a call with a synchronize; "
              f"{events_ms(fn, 50):.5f} ms by CUDA events (50 back to "
              f"back); {step_counts(fn, 1)}; device kernels "
              f"{device_kernels_ms(fn)}", flush=True)


def kscan_section(dev):
    """Kernel K's three modes (module doc)."""
    from lowlevelparticlefilters_jl_tpu_torch.kernels import _lib
    from lowlevelparticlefilters_jl_tpu_torch.kernels import assoc_scan as k

    _lib.library()
    nx = 2
    g = torch.Generator(device=dev).manual_seed(110)

    def psd(T, scale):
        h = 0.3 * torch.randn(T, nx, nx, generator=g, device=dev)
        return h @ h.mT + scale * torch.eye(nx, device=dev)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=g, device=dev)

    for T in (100_000, 1_000_000):
        filt = torch.cat([e.reshape(T, -1) for e in (
            randn(T, nx, nx, scale=0.3), randn(T, nx), psd(T, 0.1),
            randn(T, nx), psd(T, 0.1))], -1).contiguous()
        smooth = torch.cat([e.reshape(T, -1) for e in (
            randn(T, nx, nx, scale=0.4), randn(T, nx), psd(T, 0.0))],
            -1).contiguous()
        for mode, fn in (
                ("filter", lambda: k.plane_scan(filt, nx, k.FILTER)),
                ("smooth", lambda: k.plane_scan(smooth, nx, k.SMOOTH)),
                ("full", lambda: k.full_scan(filt, nx))):
            ms = events_ms(fn, 20)
            same = torch.equal(fn(), fn())
            launches = launch_list(fn)
            print(f"kscan {mode} T={T} nx={nx}: {ms:.5f} ms a call by CUDA "
                  f"events (20 back to back); two calls bitwise equal "
                  f"{same}; {len(launches)} launches a call, device "
                  f"{sum(d for _, d in launches):.5f} ms: {launches}",
                  flush=True)


def _ffbs_inputs(dev, T, N, M, nx, seed):
    """Kernel J's whitened inputs on the card: a cloud at 10 + N(0, 1),
    predicted means 0.97 x + N(0, 0.01), N(0, 1) log-weights, every 97th
    column -inf."""
    from lowlevelparticlefilters_jl_tpu_torch.kernels import ffbs

    g = torch.Generator(device=dev).manual_seed(seed)
    xf = 10.0 + torch.randn(T - 1, N, nx, generator=g, device=dev)
    xpred = 0.97 * xf + 0.1 * torch.randn(T - 1, N, nx, generator=g,
                                          device=dev)
    wf = torch.randn(T - 1, N, generator=g, device=dev)
    wf[:, ::97] = float("-inf")
    xb_T = 10.0 + torch.randn(M, nx, generator=g, device=dev)
    L = torch.linalg.cholesky(0.02 * torch.eye(nx, device=dev) + 0.01)
    mu = 0.01 * torch.arange(nx, dtype=torch.float32, device=dev)
    zpred, wfc, c, Linv = ffbs.whiten(xpred, wf, L)
    return zpred, wfc, c, xf, xb_T, Linv, mu


def ffbs_section(dev):
    """Kernel J's backward pass (module doc)."""
    import inspect

    from lowlevelparticlefilters_jl_tpu_torch.kernels import _lib, ffbs

    _lib.library()
    params = inspect.signature(ffbs.ffbs_backward_scan).parameters
    M, nx = 1000, 2
    for N, T in ((1000, 500), (65536, 24)):
        args = _ffbs_inputs(dev, T, N, M, nx, 700 + T)
        for noise in (True, False):
            fn = lambda: ffbs.ffbs_backward_scan(  # noqa: E731
                *args, 17, noise=noise)
            ms = events_ms(fn, 5)
            kern = device_kernels_ms(fn, 3)
            print(f"ffbs J N={N} T={T} M={M} nx={nx} noise={noise}: "
                  f"{ms:.4f} ms a call by CUDA events (5 back to back); "
                  f"device kernels {kern}", flush=True)
        if "stats" in params:
            st = torch.zeros(len(ffbs.CLOCKS), dtype=torch.int64, device=dev)
            rows = []
            for _ in range(5):
                ffbs.ffbs_backward_scan(*args, 17, stats=st)
                rows.append(st.tolist())
            med = [statistics.median(c) for c in zip(*rows)]
            clock, _ = clock_while(lambda: ffbs.ffbs_backward_scan(*args, 17))
            print(f"ffbs J N={N} T={T} phases (block 0's first warp, "
                  f"cycles of the loop, median of 5): "
                  f"{dict(zip(ffbs.CLOCKS, med))}; "
                  f"a step {med[-1] / (T - 1):.0f} cycles at the SM clock "
                  f"{clock} MHz", flush=True)


def _slot_bounds(we: torch.Tensor, r: float) -> torch.Tensor:
    """Systematic slot boundaries of the weights ``we`` [N] at offset r,
    formed here in float64 so that every tree gets valid ones."""
    N = we.shape[0]
    bins = torch.cumsum(we.double(), 0)
    K = torch.ceil(bins * N / bins[-1] - r).to(torch.int32)
    return torch.cummax(K, 0).values.clamp(0, N)


def _word_aligned(x: torch.Tensor) -> torch.Tensor:
    """A copy of ``x`` one element past an aligned address, so that
    kernel B copies its rows of 8 (16) bytes word by word and not as one
    vector."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


def gather_section(dev):
    """Kernel B given the same slot boundaries (module doc)."""
    from lowlevelparticlefilters_jl_tpu_torch.kernels import (
        _lib, resample_route)

    _lib.library()
    nx = 2
    for N in (100_000, (1 << 24) + 1, 1 << 25):
        g = torch.Generator(device=dev).manual_seed(N)
        x = torch.randn(N, nx, generator=g, device=dev)
        for prof in ("uniform", "U^20"):
            we = torch.rand(N, generator=g, device=dev, dtype=torch.float64)
            we = torch.ones_like(we) if prof == "uniform" else we ** 20
            K = _slot_bounds(we, 0.37)
            fn = lambda: resample_route.systematic_gather(x, K)  # noqa: E731
            same = torch.equal(fn(), resample_route.systematic_gather_plain(
                x, K))
            bound = N * (4 + 2 * 4 * nx) / 3.35e12 * 1e3
            if N <= 100_000:
                kern = device_kernels_ms(fn, 50)
                dev_ms = sum(kern.values())
                print(f"gather B N={N} nx={nx} {prof}: device {dev_ms:.5f} "
                      f"ms a call by torch.profiler (50 calls) {kern}; "
                      f"{events_ms(fn, 50):.5f} ms by CUDA events; bitwise "
                      f"{same}; bound {bound:.6f} ms", flush=True)
            else:
                ms = events_ms(fn, 20)
                print(f"gather B N={N} nx={nx} {prof}: {ms:.5f} ms a call by "
                      f"CUDA events (20 back to back); bitwise {same}; bytes "
                      f"bound {bound:.5f} ms, {bound / ms:.3f} of it",
                      flush=True)
        if N == (1 << 24) + 1:
            continue
        # rows as one vector (aligned) against word by word (x one word
        # off), float32 and float64, in turns
        for dt in (torch.float32, torch.float64):
            xa = x.to(dt)
            xw = _word_aligned(xa)
            times = {"vector": [], "words": []}
            for _ in range(2):
                for how, xi in (("vector", xa), ("words", xw), ("words", xw),
                                ("vector", xa)):
                    fn = lambda: resample_route.systematic_gather(  # noqa: E731
                        xi, K)
                    assert torch.equal(fn(), resample_route.
                                       systematic_gather_plain(xa, K))
                    if N <= 100_000:
                        t = sum(device_kernels_ms(fn, 50).values())
                    else:
                        t = events_ms(fn, 20)
                    times[how].append(t)
            unit = "device ms" if N <= 100_000 else "ms by CUDA events"
            print(f"gather B N={N} nx={nx} {str(dt)[6:]} U^20 rows as one "
                  f"vector {times['vector']} against word by word "
                  f"{times['words']} ({unit}); bitwise True", flush=True)


def _bank_inputs(dev, Bk, T, seed):
    """Kernel F's inputs on the benchmark's bank model: the port's shared
    recursion and scalars, N(0, 1) outputs and 0.3 N(0, 1) inputs."""
    from lowlevelparticlefilters_jl_tpu_torch import convert
    from lowlevelparticlefilters_jl_tpu_torch.filters import bank as tbank
    from lowlevelparticlefilters_jl_tpu_torch.kernels import bank_scan

    A = [[0.97043, -0.097368], [0.097368, 0.970437]]
    kf = convert.kalman_filter_from_numpy(
        A, [[0.1], [0.0]], [[1.0, 0.0], [0.0, 1.0]], 0,
        [[0.01, 0.0], [0.0, 0.01]], [[0.1, 0.0], [0.0, 0.1]],
        dtype=torch.float32, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    ys = torch.randn(Bk, T, 2, generator=g, device=dev)
    us = 0.3 * torch.randn(Bk, T, 1, generator=g, device=dev)
    _, Sch, K, _, Am, Bm, Cm, Dm = tbank._shared_recursion(
        kf, T, torch.float32, dev)
    scal, _ = bank_scan.bank_scalars(Sch, K, Am, Bm, Cm, Dm, 1)
    return kf, scal, ys, us, kf.d0.mean.float().contiguous()


def bank_section(dev):
    """Kernel F's scan (module doc)."""
    import inspect

    import lowlevelparticlefilters_jl_tpu_torch as llpt
    from lowlevelparticlefilters_jl_tpu_torch.kernels import _lib, bank_scan

    _lib.library()
    params = inspect.signature(bank_scan.bank_loglik_scan).parameters
    for Bk, T in ((1024, 200), (8192, 2000), (256, 10_000), (8192, 2001),
                  (8192, 2002)):
        kf, scal, ys, us, x0 = _bank_inputs(dev, Bk, T, 900 + Bk)
        S = scal.shape[1]
        bound = 4 * (Bk * T * 3 + T * S + 2 + Bk) / 3.35e12 * 1e3
        fn = lambda: bank_scan.bank_loglik_scan(  # noqa: E731
            scal, ys, us, x0, 2, 2, 1)
        reps = 50 if Bk * T <= 1e6 else 20
        ms = events_ms(fn, reps)
        kern = device_kernels_ms(fn, 10)
        dev_ms = sum(kern.values())
        line = (f"bank F B={Bk} T={T}: {ms:.5f} ms a call by CUDA events "
                f"({reps} back to back); device {dev_ms:.5f} ms "
                f"(torch.profiler, 10 calls) {kern}; bytes bound "
                f"{bound:.6f} ms, {bound / dev_ms:.3f} of it")
        if Bk == 1024:
            diff = (fn() - bank_scan.bank_loglik_scan_plain(
                scal, ys, us, x0, 2, 2, 1)).abs().max()
            line += f"; max |kernel - twin| {float(diff):.3g}"
        print(line, flush=True)
        if T in (200, 2000):
            med = host_ms(lambda: llpt.kf_bank_loglik(kf, us, ys), 20)
            print(f"bank kf_bank_loglik B={Bk} T={T}: host median {med:.4f} "
                  f"ms (20 calls, synchronize each), route "
                  f"{llpt.last_route('kf_bank_loglik')}", flush=True)
        if "stats" in params:
            st = torch.zeros(len(bank_scan.CLOCKS), dtype=torch.int64,
                             device=dev)
            rows = []
            for _ in range(5):
                bank_scan.bank_loglik_scan(scal, ys, us, x0, 2, 2, 1,
                                           stats=st)
                rows.append(st.tolist())
            med = [statistics.median(c) for c in zip(*rows)]
            nseg = -(-T // (32 * bank_scan.bank_plan(T, 2, 2, 1)))
            print(f"bank F B={Bk} T={T} one member a warp, block 0's first "
                  f"warp's clock64 cycles (median of 5): "
                  f"{dict(zip(bank_scan.CLOCKS, med))}; {nseg} segments, "
                  f"{med[-1] / nseg:.0f} cycles a segment", flush=True)


def main():
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    args = sys.argv[1:]
    out = ROOT / "probe_out"
    if "--out" in args:
        k = args.index("--out")
        out = Path(args[k + 1])
        del args[k:k + 2]
    sections = set(args) or {"noise", "scan", "pf", "sync", "akf", "prop",
                             "resample", "kscan", "ffbs", "gather", "bank"}
    print(f"clocks: {smi('clocks.sm,clocks.max.sm')}", flush=True)
    if "noise" in sections:
        noise_section(dev)
    if "scan" in sections:
        scan_section(dev, out)
    if "pf" in sections:
        pf_section(dev)
    if "sync" in sections:
        sync_section(dev)
    if "akf" in sections:
        akf_section(dev)
    if "prop" in sections:
        prop_section(dev)
    if "resample" in sections:
        resample_section(dev)
    if "kscan" in sections:
        kscan_section(dev)
    if "ffbs" in sections:
        ffbs_section(dev)
    if "gather" in sections:
        gather_section(dev)
    if "bank" in sections:
        bank_section(dev)

    print(smi("name,power.limit"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
