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
   ``noise_backend="kernel"`` (kernels B, C, D), within 1 % of the KF.

Launch counts are reset just before phase 4 and read after phase 5; every
kernel must have launched in that run.  The kernels line and the card's
``nvidia-smi`` line come before the last line,
``{"ok": true, "device": {...}}``.  Imports no JAX.
"""
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

SEED = 0
N_MAIN, T_MAIN, THRESH = 100_000, 1000, 0.1


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


def nvidia_smi_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    sys.path[:0] = [str(root), str(root / "tests")]
    import lowlevelparticlefilters_jl_tpu_torch as llpt
    from _torch_parity import lattice_case
    from lowlevelparticlefilters_jl_tpu_torch import convert
    from lowlevelparticlefilters_jl_tpu_torch.kernels import (
        _lib, noise, pf_scan, resample_route)
    from lowlevelparticlefilters_jl_tpu_torch.ops import resample as ors

    dev = torch.device("cuda")
    kernels = [pf_scan.PF_LOGLIK_SCAN, resample_route.SYSTEMATIC_GATHER,
               noise.NORMAL, noise.ADD_GAUSSIAN_NOISE]
    stats = {k.name: {} for k in kernels}

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
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line:
            log("build", line.strip())

    # the benchmark's model and data: KF simulate in f64 on the CPU
    A = [[0.97043, -0.097368], [0.097368, 0.970437]]
    B, C = [[0.1], [0.0]], [[1.0, 0.0], [0.0, 1.0]]
    R1 = [[0.01, 0.0], [0.0, 0.01]]
    R2 = [[0.1, 0.0], [0.0, 0.1]]
    kf = convert.kalman_filter_from_numpy(A, B, C, 0, R1, R2)

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
            7, N_MAIN * 2, tag=noise.TAG_INIT, device=dev), 5))
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
            xn, L1, 11, 3), 5))
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
    stats["systematic_gather"]["max_abs_err"] = worst
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
    stats["pf_loglik_scan"] = dict(
        max_abs_err=worst,
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
    launches = {k.name: k.launches for k in kernels}
    log("unfused", f"forward_trajectory N={N_MAIN} T={T5} kernel noise: ll "
        f"{float(sol.ll)} KF {ll_kf5} rel {rel5:.3g}; launches {launches}")
    for k in kernels:
        require(k.launches >= 1, f"kernel {k.name} launched in the main run")
        require(k.name != "pf_loglik_scan" or k.launches == 1,
                "kernel A launched once")

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
