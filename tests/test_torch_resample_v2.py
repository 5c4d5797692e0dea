"""PyTorch port: kernel E (kernels/resample_v2.py), the systematic index
and gather in one launch, against the JAX package's
``ops/pallas/resample_v2.py::fused_systematic_gather`` in interpret mode.

The JAX entry draws the offset r from its key; the port's twin is given
that same r, so K, j and the gathered rows are bitwise equal.  Then the
particle filter's ``exact_resample`` branch, which takes E, against the
default branch, which takes kernel B: a seeded run gives the same bits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lowlevelparticlefilters_jl_tpu.ops.pallas.resample_v2 import (
    fused_systematic_gather as jax_fused_systematic_gather)
import lowlevelparticlefilters_jl_tpu_torch as llpt
from lowlevelparticlefilters_jl_tpu_torch import convert
from lowlevelparticlefilters_jl_tpu_torch.kernels import resample_v2
from lowlevelparticlefilters_jl_tpu_torch.ops.resample import resample_gather
from _torch_parity import A, B, C, R1, R2


def _weights(profile, N, rng):
    if profile == "skewed":
        we = np.abs(rng.normal(size=N)) ** 30.0 + 1e-12
    else:  # all the weight on one particle
        we = np.zeros(N)
        we[777] = 1.0
    return (we / we.sum()).astype(np.float32)


@pytest.mark.parametrize("profile,nx", [("skewed", 3), ("single", 2)])
def test_twin_bitwise_equals_jax_kernel(profile, nx):
    N = 2048
    rng = np.random.default_rng(3)
    we = _weights(profile, N, rng)
    x = rng.normal(size=(N, nx)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    out_j, j_j = jax_fused_systematic_gather(jnp.asarray(x), jnp.asarray(we),
                                             key)
    r = torch.tensor(float(jax.random.uniform(key, (), jnp.float32)))
    before = resample_v2.SYSTEMATIC_INDEX_GATHER.launches
    out_t, j_t = llpt.fused_systematic_gather(torch.tensor(x),
                                              torch.tensor(we), r=r)
    assert resample_v2.SYSTEMATIC_INDEX_GATHER.launches == before  # twin
    assert j_t.dtype == torch.int32
    np.testing.assert_array_equal(j_t.numpy(), np.asarray(j_j))
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))
    if profile == "single":
        assert bool((j_t == 777).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gather_helper_exact_equals_default(dtype):
    """``resample_gather`` with ``exact`` (kernel E's route) gives the same
    rows as the default route (kernel B's) from one generator state."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn(1000, 4, generator=g, dtype=dtype)
    we = torch.rand(1000, generator=g, dtype=dtype) ** 8
    we = we / we.sum()
    a = resample_gather(x, we, torch.Generator().manual_seed(1), exact=True)
    b = resample_gather(x, we, torch.Generator().manual_seed(1))
    assert torch.equal(a, b)


def test_pf_exact_resample_bitwise_equals_default():
    """A seeded ``forward_trajectory`` with ``exact_resample`` (E) and
    without (B): both draw the same r and the same K, so every output is
    bitwise equal; and the run does resample."""
    f, g = convert.linear_callbacks(A, B, C, device="cpu")
    kf = convert.kalman_filter_from_numpy(A, B, C, 0, R1, R2, device="cpu")
    u = torch.full((40, 1), 0.3, dtype=torch.float64)
    _, u, y = llpt.simulate(kf, u, torch.Generator().manual_seed(2))
    sols = []
    for exact in (True, False):
        pf = convert.particle_filter_from_numpy(
            500, f, g, R1, R2, R1, exact_resample=exact, device="cpu")
        sols.append(pf.forward_trajectory(
            u.float(), y.float(), generator=torch.Generator().manual_seed(9)))
    for name in ("x", "w", "we", "ll"):
        assert torch.equal(getattr(sols[0], name), getattr(sols[1], name))
    neff = 1.0 / (sols[0].we ** 2).sum(-1)
    assert int((neff < 0.1 * 500).sum()) >= 1
