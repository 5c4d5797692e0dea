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
6. the KF bank, ``kf_bank_loglik`` on the benchmark's bank model
   (bench.py:423-469): kernel F against its twin at B = 1024, T = 200;
   the route and one launch each of kernels K and F per call at B = 1024
   and B = 8192; ll against a float64 CPU oracle; median time of 5.
7. the temporal-parallel KF (bench.py:724-736): kernel K's filter and
   smooth scans against their twin at T = 1e5; ``loglik``,
   ``forward_trajectory`` and ``parallel_rts_smooth`` on CUDA tensors
   against float64 CPU references at T = 2000, 1e5 and 1e6; median time
   of 5 ``loglik`` calls at T = 1e5.

Launch counts are reset just before each path's run (phases 4-5, 6 and
7) and read just after it; every kernel of the path must have launched
there.  The kernels line (with each kernel's bound: the larger of its
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

import torch

SEED = 0
N_MAIN, T_MAIN, THRESH = 100_000, 1000, 0.1
T_BANK, T_PAR = 200, 100_000
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
    from lowlevelparticlefilters_jl_tpu_torch.filters import bank as tbank
    from lowlevelparticlefilters_jl_tpu_torch.kernels import (
        _lib, assoc_scan, bank_scan, noise, pf_scan, resample_route)
    from lowlevelparticlefilters_jl_tpu_torch.ops import resample as ors
    from lowlevelparticlefilters_jl_tpu_torch.parallel import temporal

    dev = torch.device("cuda")
    kernels = [pf_scan.PF_LOGLIK_SCAN, resample_route.SYSTEMATIC_GATHER,
               noise.NORMAL, noise.ADD_GAUSSIAN_NOISE, bank_scan.BANK_LOGLIK,
               assoc_scan.ASSOC_SCAN]
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
    nx_, ny_ = 2, 2
    # per particle-step: predict 4nx^2 + 4nx, one Philox call and nx
    # normals, the whitened Gaussian weight 2ny nx + 2ny^2 + 4ny, the
    # normalization ~12; per particle of a resampling step the quantized
    # scan, the slot and its binary search
    ops_a = (N_MAIN * T_MAIN * (4 * nx_ ** 2 + 4 * nx_ + 2 * ny_ * nx_
                                + 2 * ny_ ** 2 + 4 * ny_ + 12 + PHILOX_OPS
                                + nx_ * NORMAL_OPS)
             + nres * N_MAIN * (30 + 2 * math.ceil(math.log2(N_MAIN))
                                + nx_))
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
