#!/usr/bin/env python3
"""Probe kernels C (normal draws) and G, H, I (whole scans) on the card:
device time against host time, and the compiled step loops.

    python3 scripts/torch_kernel_probe.py [noise] [scan] [--out DIR]

Needs one CUDA card.  Runs the named sections (both without arguments).
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


def device_kernels_ms(fn, reps=20):
    """{kernel name: device ms a call} by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.events():
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
    sections = set(args) or {"noise", "scan"}
    print(f"clocks: {smi('clocks.sm,clocks.max.sm')}", flush=True)
    if "noise" in sections:
        noise_section(dev)
    if "scan" in sections:
        scan_section(dev, out)

    print(smi("name,power.limit"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
