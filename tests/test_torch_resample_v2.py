"""PyTorch port: kernel E (kernels/resample_v2.py), the systematic index
and gather in one launch, against the JAX package's
``ops/pallas/resample_v2.py::fused_systematic_gather`` in interpret mode.

The JAX entry draws the offset r from its key; the port's twin is given
that same r, so K, j and the gathered rows are bitwise equal.  Then the
particle filter's ``exact_resample`` branch, which takes E, against the
default branch, which takes kernel B: a seeded run gives the same bits.

On the card E sums the weights in its own fixed order
(``resample_v2.runs_prefix``), which its twins repeat op for op: the
order is pinned here against a loop over Python floats, and the twins'
slot boundaries are held against JAX's ``_systematic_slots``, equal
except where a slot's value ``cdf * M / total - r`` lies within a few
ulps of an integer (a tie that one rounding of the prefix decides).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lowlevelparticlefilters_jl_tpu.ops import resample as jrs
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
    before = resample_v2.SYSTEMATIC_RESAMPLE.launches
    out_t, j_t = llpt.fused_systematic_gather(torch.tensor(x),
                                              torch.tensor(we), r=r)
    assert resample_v2.SYSTEMATIC_RESAMPLE.launches == before  # twin
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


def _runs_prefix_loop(v, run=32):
    """kernel E's summation order over Python floats (float64): runs of
    ``run`` summed left to right, the runs' totals by the same rule, each
    partial offset by the inclusive prefix of the runs before it."""
    if len(v) <= run:
        out, a = [], 0.0
        for x in v:
            a = a + x
            out.append(a)
        return out
    part, tot = [], []
    for r0 in range(0, len(v), run):
        a = 0.0
        for x in v[r0:r0 + run]:
            a = a + x
            part.append(a)
        tot.append(a)
    before = _runs_prefix_loop(tot, run)
    return [(before[i // run - 1] if i >= run else 0.0) + part[i]
            for i in range(len(v))]


@pytest.mark.parametrize("n", [1, 31, 32, 33, 1025, 33_000])
def test_runs_prefix_is_the_kernel_order(n):
    """The twins' prefix is the fixed order written out (bitwise), and a
    prefix sum (within float64 rounding of ``torch.cumsum``'s)."""
    v = np.random.default_rng(n).random(n) ** 8
    got = resample_v2.runs_prefix(torch.tensor(v))
    np.testing.assert_array_equal(got.numpy(), np.array(_runs_prefix_loop(
        v.tolist())))
    np.testing.assert_allclose(got.numpy(), np.cumsum(v), rtol=1e-13)


def _ties(Kt, Kj, we, r, M):
    """The slots where Kt and Kj differ, each checked to be a tie: the two
    differ by one, and the float64 slot value ``cdf * M / total - r`` of
    that particle, or of an earlier one with the same cdf to rounding (the
    running max carries a boundary forward), lies within 64 ulps of the
    weights' dtype (times M) of an integer."""
    bad = np.nonzero(Kt != Kj)[0]
    assert np.all(np.abs(Kt[bad].astype(np.int64) - Kj[bad]) == 1), bad[:8]
    cdf = np.cumsum(we.astype(np.float64))
    v = cdf * M / cdf[-1] - r
    tol = 64 * np.finfo(we.dtype).eps
    near = np.abs(v - np.round(v)) <= tol * M
    for i in bad:
        same = cdf[:i + 1] >= cdf[i] - tol * cdf[-1]
        assert near[:i + 1][same].any(), f"boundary {i} moved without a tie"
    return bad


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind", ["uniform", "skewed", "single"])
def test_slot_stage_twin_matches_jax_slots(dtype, kind):
    """The slot stage's twin (kernel E's arithmetic on any device) against
    JAX's ``_systematic_slots`` on the same weights and r: the same K, and
    so the same resampled counts, except at one-ulp ties; and the whole
    resample's twin gives ``x[j]`` for its own K."""
    N = 4096
    rng = np.random.default_rng(7)
    we = {"uniform": np.ones(N), "skewed": rng.random(N) ** 20,
          "single": np.eye(1, N, 1234)[0]}[kind]
    we = (we / we.sum()).astype(dtype)
    key = jax.random.PRNGKey(3)
    Kj = np.asarray(jrs._systematic_slots(jnp.asarray(we), key, N))
    r = float(jax.random.uniform(key, (), jnp.asarray(we).dtype))
    Kt = resample_v2.systematic_slots_plain(torch.tensor(we),
                                            torch.tensor(r), N).numpy()
    assert Kt.dtype == np.int32 and np.all(np.diff(Kt) >= 0)
    bad = _ties(Kt, Kj, we, r, N)
    assert bad.size <= 4
    counts = [np.diff(K.astype(np.int64), prepend=0) for K in (Kt, Kj)]
    moved = np.zeros(N + 1, bool)
    moved[bad] = moved[bad + 1] = True
    np.testing.assert_array_equal(counts[0][~moved[:N]],
                                  counts[1][~moved[:N]])
    x = rng.normal(size=(N, 3)).astype(dtype)
    out, j = resample_v2.systematic_resample_plain(
        torch.tensor(x), torch.tensor(we), torch.tensor(r))
    jt = np.searchsorted(Kt, np.arange(N), side="right").clip(max=N - 1)
    np.testing.assert_array_equal(j.numpy(), jt)
    np.testing.assert_array_equal(out.numpy(), x[jt])


@pytest.mark.parametrize("shape,dtype,takes", [
    ((1 << 24,), torch.float32, True),
    (((1 << 24) + 1,), torch.float32, False),
    ((1 << 24,), torch.float64, True), ((4096,), torch.float16, False),
    ((0,), torch.float32, False), ((2, 4096), torch.float32, False)])
def test_route_predicate(shape, dtype, takes):
    """Kernel E's admission (``kernel_takes``), asked of shapes: 1-D,
    float32 or float64, 1 <= N <= 2^24.  Its checks (``_weights``) use it:
    a tensor it refuses raises there, TypeError for the dtype or shape,
    ValueError for N, so the card's route (``_systematic_slots``: E's slot
    stage or ``_cumsum``) and the kernel agree.  Small tensors stand for
    the refusals that do not depend on N."""
    assert resample_v2.kernel_takes(shape, dtype) is takes
    if len(shape) == 1 and shape[0] > 4096:
        return
    we = torch.ones(shape, dtype=dtype)
    if takes:
        resample_v2._weights(we, 0.5, shape[0], "t")
    else:
        with pytest.raises(TypeError if dtype == torch.float16 or len(shape)
                           > 1 else ValueError):
            resample_v2._weights(we, 0.5, shape[-1], "t")
