"""PyTorch port: kernel A's resample as its blocks compute it
(csrc/pf_scan.cu), modelled in plain PyTorch and held bit for bit to the
plain twin's systematic slots (``kernels/pf_scan.quantized_slots`` and
``resample_route.slot_sources``).

In the kernel, block b of G owns particles and slots [b·per, (b+1)·per),
per = ceil(N / G).  It quantizes its weights and scans them into a local
integer prefix C_loc; after one grid sync every block scans the G block
totals into the offsets P_b and K at every block's last particle, Kend_b.
Slot k's source block is the first with Kend_b > k, and its particle the
first of that block with K(P_b + C_loc_j) > k (K = clip(ceil(C·scale − r),
0, N), scale = N / total, all in f32).  The model below does the same
arithmetic, block by block, at G = 1, 7 and 391 (the old kernel's grid
at N = 1e5), on random, U^20, single-particle and 0/1 (lattice) weights.
"""
import numpy as np
import pytest
import torch

from lowlevelparticlefilters_jl_tpu_torch.kernels.pf_scan import (
    quantized_slots)
from lowlevelparticlefilters_jl_tpu_torch.kernels.resample_route import (
    slot_sources)


def _k_of(c: torch.Tensor, scale: torch.Tensor, r: torch.Tensor, N: int):
    """K of global inclusive prefixes c, as the kernel's k_of."""
    return torch.ceil(c.to(torch.float32) * scale - r).clamp_(0, N).to(
        torch.int64)


def block_sources(weu, s1, r, N: int, G: int) -> torch.Tensor:
    """The slot sources of the kernel's block resample (module doc)."""
    per = -(-N // G)
    wi = torch.floor((weu / s1) * 16777216.0 + 0.5).to(torch.int64)
    starts = [min(N, b * per) for b in range(G + 1)]
    c_loc = [torch.cumsum(wi[starts[b]:starts[b + 1]], 0) for b in range(G)]
    tot = torch.tensor([int(c[-1]) if c.numel() else 0 for c in c_loc])
    P = torch.cumsum(tot, 0) - tot  # the exclusive block offsets
    scale = torch.tensor(float(N), dtype=torch.float32) / torch.tensor(
        float(int(tot.sum())), dtype=torch.float32)
    kend = _k_of(P + tot, scale, r, N)
    k = torch.arange(N)
    src = torch.full((N,), N - 1, dtype=torch.int64)
    blk = torch.searchsorted(kend, k, right=True)  # first Kend_b > k
    for b in torch.unique(blk).tolist():
        if b == G:
            continue  # no block ends past slot k: the last particle
        sel = blk == b
        K_b = _k_of(P[b] + c_loc[b], scale, r, N)
        src[sel] = starts[b] + torch.searchsorted(K_b, k[sel], right=True)
    return src


def _weights(profile: str, N: int, g: torch.Generator) -> torch.Tensor:
    if profile == "random":
        return torch.rand(N, generator=g)
    if profile == "pow20":
        return torch.rand(N, generator=g) ** 20
    if profile == "single":
        w = torch.zeros(N)
        w[int(torch.randint(0, N, (1,), generator=g))] = 1.0
        return w
    return (torch.rand(N, generator=g) < 0.3).to(torch.float32)  # lattice


@pytest.mark.parametrize("G", [1, 7, 391])
@pytest.mark.parametrize("profile", ["random", "pow20", "single", "lattice"])
def test_block_resample_matches_twin_slots(G, profile):
    g = torch.Generator().manual_seed(G * 31 + len(profile))
    for N in (G * 3 + 1, 100_003):
        weu = _weights(profile, N, g)
        if profile == "lattice" and not bool(weu.any()):
            weu[0] = 1.0
        s1 = weu.sum()
        for r in (torch.tensor(0.5), torch.rand((), generator=g)):
            want = slot_sources(quantized_slots(weu, s1, r, N))
            got = block_sources(weu, s1, r, N, G)
            assert torch.equal(got, want.to(torch.int64)), (N, float(r))
    # a heavy particle's copies cross block boundaries
    assert np.unique(want.numpy()).size < N
