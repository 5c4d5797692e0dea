#!/usr/bin/env python3
"""The relative gap between the stochastic EnKF's log-likelihood and the
exact KF's, on the benchmark's 2-state model (bench.py:389-393, u = 0.3)
at chip_smoke.py phase 21's size: N = 1e4 members, T = 1000, over five
seeds (the data and the EnKF's generator both from the seed).

    python3 scripts/torch_enkf_gap.py [--device cpu|cuda] [--dtype f32|f64]

Runs on the CPU by default, in float32 like the card.  Prints each seed's
gap and the largest; ``chip_smoke.py``'s ``ENKF_LL_REL`` is three times
the largest gap this script printed on the CPU (see ``PERF.md``).
"""
import argparse
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import lowlevelparticlefilters_jl_tpu_torch as llpt  # noqa: E402
from lowlevelparticlefilters_jl_tpu_torch import convert  # noqa: E402

A = [[0.97043, -0.097368], [0.097368, 0.970437]]
B, C = [[0.1], [0.0]], [[1.0, 0.0], [0.0, 1.0]]
R1 = [[0.01, 0.0], [0.0, 0.01]]
R2 = [[0.1, 0.0], [0.0, 0.1]]
N, T, SEEDS, DATA_SEED = 10_000, 1000, 5, 210


def gap(seed: int, device: str, dtype) -> float:
    """|ll_EnKF - ll_KF| / |ll_KF| on the data of ``DATA_SEED + seed``."""
    kf = convert.kalman_filter_from_numpy(A, B, C, 0, R1, R2, device="cpu")
    u = torch.full((T, 1), 0.3, dtype=torch.float64)
    _, u, y = llpt.simulate(kf, u,
                            torch.Generator().manual_seed(DATA_SEED + seed))
    ll_kf = float(llpt.loglik(kf, u, y))
    f, g = convert.linear_callbacks(A, B, C, dtype=dtype, device=device)
    enkf = convert.enkf_from_numpy(N, f, g, R1, R2, None, R1, nu=1,
                                   dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    ll = float(llpt.loglik(enkf, u.to(device, dtype), y.to(device, dtype),
                           generator=gen))
    return abs(ll - ll_kf) / abs(ll_kf)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--dtype", default="f32", choices=("f32", "f64"))
    a = ap.parse_args()
    dtype = torch.float32 if a.dtype == "f32" else torch.float64
    gaps = []
    for s in range(SEEDS):
        t0 = time.perf_counter()
        gaps.append(gap(s, a.device, dtype))
        print(f"seed {s}: |ll - ll_KF| / |ll_KF| = {gaps[-1]:.6g} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    print(f"N={N} T={T} {a.device} {a.dtype}: largest gap {max(gaps):.6g}, "
          f"three times {3 * max(gaps):.6g}")


if __name__ == "__main__":
    main()
