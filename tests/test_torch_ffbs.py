"""PyTorch port: the FFBS particle smoother (smoothing.py::ffbs_smooth)
and the plain twin of kernel J (kernels/ffbs.py) against the JAX
package's.

- The twin in MAP mode (no noise) against ``ffbs_backward_pallas`` run in
  interpret mode, as tests/test_ffbs_kernel.py runs it: the same rows,
  exactly (an exact selection of particles; the float32 scores of the two
  whitenings differ in the last bits, far from a near-tie here).
- The plain backward loop against the JAX XLA path (``backend="xla"``) on
  one shared forward pass, with JAX's own Gumbel draws and terminal
  indices fed to the port: the same trajectories, exactly.
- The twin's inverse-CDF draws against the categorical law they sample,
  their edge rows, and their summation order against a scalar loop.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import A, B, R1, R2

import lowlevelparticlefilters_jl_tpu as llpf
import lowlevelparticlefilters_jl_tpu_torch as llpt
from lowlevelparticlefilters_jl_tpu.ops.pallas.ffbs_kernel import (
    ffbs_backward_pallas)
from lowlevelparticlefilters_jl_tpu.ops.resample import resample as jresample
from lowlevelparticlefilters_jl_tpu_torch import convert, smoothing
from lowlevelparticlefilters_jl_tpu_torch.kernels import ffbs


def _cloud(T, N, M, nx, seed, shift=50.0):
    """Forward clouds far from the origin (the centring's case), with two
    columns of weight -inf at every step."""
    rng = np.random.default_rng(seed)
    xf = (shift + rng.normal(size=(T - 1, N, nx))).astype(np.float32)
    xpred = (0.97 * xf + 0.1 * rng.normal(size=xf.shape)).astype(np.float32)
    wf = rng.normal(size=(T - 1, N)).astype(np.float32)
    wf[:, [3, 77]] = -np.inf
    xb_T = (shift + rng.normal(size=(M, nx))).astype(np.float32)
    L = np.linalg.cholesky(np.array([[0.04, 0.01], [0.01, 0.09]]))
    return xf, xpred, wf, xb_T, L.astype(np.float32), \
        np.array([0.05, -0.02], np.float32)


def test_twin_map_matches_pallas_interpret():
    T, N, M, nx = 4, 128, 8, 2
    xf, xpred, wf, xb_T, L, mu = _cloud(T, N, M, nx, 0)
    ref = np.asarray(ffbs_backward_pallas(
        jnp.asarray(xpred), jnp.asarray(wf), jnp.asarray(xf),
        jnp.asarray(xb_T), jnp.asarray(L), jnp.asarray(mu), 7))
    t = torch.tensor
    out, idx = ffbs.ffbs_backward(t(xpred), t(wf), t(xf), t(xb_T), t(L),
                                  t(mu), 7, noise=False, return_indices=True)
    assert out.shape == (T, M, nx) and idx.shape == (T - 1, M)
    np.testing.assert_array_equal(out.numpy(), ref)
    for s in range(T - 1):  # rows are the chosen particles, never a -inf one
        np.testing.assert_array_equal(out[s].numpy(), xf[s][idx[s].numpy()])
    assert not np.isin(idx.numpy(), [3, 77]).any()
    # the twin is what the scan entry point runs on CPU tensors
    zpred, wfc, c, Linv = ffbs.whiten(t(xpred), t(wf), t(L))
    again = ffbs.ffbs_backward_scan(zpred, wfc, c, t(xf), t(xb_T), Linv,
                                    t(mu), 7, noise=False)
    assert torch.equal(again, out)


@pytest.mark.parametrize("N,cols,M", [(4, (0, 1, 2, 3), 20000),
                                      (2100, (5, 1100, 2050, 2099), 6000)])
def test_twin_inverse_cdf_draws_sample_the_weights(N, cols, M):
    """One step, M trajectories from one backward state, log-weights
    (0, -1, 0.5, -inf) on four columns (the rest -inf; N = 2100 spreads
    them over three chunks of 1024): each column's share is softmax(w)
    within 4 standard errors and the -inf column is never drawn; the
    uniforms lie strictly inside (0, 1) and differ between steps and
    trajectories."""
    w = torch.full((1, N), float("-inf"))
    w[0, list(cols)] = torch.tensor([0.0, -1.0, 0.5, float("-inf")])
    xf = torch.arange(N, dtype=torch.float32).reshape(1, N, 1)
    out, idx = ffbs.ffbs_backward_plain(
        torch.zeros(1, N, 1), w, torch.zeros(1, 1), xf, torch.zeros(M, 1),
        torch.ones(1, 1), torch.zeros(1), 11, return_indices=True)
    share = torch.bincount(idx[0].long(), minlength=N).double() / M
    p = torch.softmax(w[0].double(), 0)
    assert bool(((share - p).abs() <= 4 * (p * (1 - p) / M).sqrt()).all())
    assert int((idx == cols[3]).sum()) == 0
    u = ffbs.uniforms_plain(3, 2, 4096)
    assert bool((u > 0).all() and (u < 1).all())
    assert abs(float(u.mean()) - 0.5) < 0.02
    assert not torch.equal(u, ffbs.uniforms_plain(3, 1, 4096))


def test_inverse_cdf_edges():
    """The draw's edge rows: no finite score (NaN and -inf) takes column
    0; u * total = total takes the last column of nonzero weight; a tiny
    u the first; a -inf or NaN column is never drawn, in one chunk or
    across chunks (the first chunk all -inf)."""
    inf = float("inf")
    w = torch.tensor([[-inf, float("nan"), -inf, -inf],
                      [-inf, 0.0, 0.5, -inf],
                      [-inf, 0.0, 0.5, -inf],
                      [float("nan"), -1.0, -inf, 2.0]])
    col = ffbs.inverse_cdf_plain(w, torch.tensor([0.5, 1.0, 1e-7, 1.0]))
    assert col.tolist() == [0, 2, 1, 3]
    big = torch.full((2, 3000), -inf)
    big[:, 1500] = 0.0
    big[:, 2999] = -3.0
    big[1, 2500] = float("nan")
    col = ffbs.inverse_cdf_plain(big, torch.tensor([1e-7, 1.0]))
    assert col.tolist() == [1500, 2999]


@pytest.mark.parametrize("R", [1, 3])
def test_lane_prefix_is_the_kernel_order(R):
    """The twin's summation order, written in PyTorch ops
    (``ffbs.lane_prefix``), equals a loop over float32 scalars in kernel
    J's order: each lane's prefix left to right, then the lanes' totals
    by the Kogge-Stone scan (add the value 1, 2, 4, 8, 16 lanes down)."""
    rng = np.random.default_rng(R)
    e = (rng.random((2, R, 32)) ** 8).astype(np.float32)
    Q, E, tot = ffbs.lane_prefix(torch.tensor(e))
    f32 = np.float32
    for b in range(2):
        q = np.zeros((R, 32), np.float32)
        for lane in range(32):
            acc = f32(0.0)
            for i in range(R):
                acc = f32(acc + e[b, i, lane])
                q[i, lane] = acc
        incl = [q[R - 1, lane] for lane in range(32)]
        for d in (1, 2, 4, 8, 16):
            incl = [f32(incl[lane] + incl[lane - d]) if lane >= d
                    else incl[lane] for lane in range(32)]
        np.testing.assert_array_equal(Q[b].numpy(), q)
        np.testing.assert_array_equal(E[b].numpy(), [0.0] + incl[:31])
        assert tot[b].item() == incl[31]


def _models(N, dtype):
    """The benchmark's FFBS model (bench.py:552-564) in both packages."""
    Aj, Bj = jnp.asarray(A, dtype), jnp.asarray(B, dtype)
    pf_j = llpf.ParticleFilter(
        N=N, dynamics=lambda x, u, p, t: Aj @ x + Bj @ u,
        measurement=lambda x, u, p, t: x,
        dynamics_density=jnp.asarray(R1, dtype),
        measurement_density=jnp.asarray(R2, dtype),
        initial_density=jnp.asarray(R1, dtype))
    f, _ = convert.linear_callbacks(A, B, np.eye(2), dtype=torch.float64,
                                    device="cpu")
    pf_t = convert.particle_filter_from_numpy(
        N, f, lambda x, u, p, t: x, R1, R2, R1, dtype=torch.float64,
        device="cpu")
    kf = convert.kalman_filter_from_numpy(A, B, np.eye(2), 0, R1, R2,
                                          device="cpu")
    return pf_j, pf_t, kf


def test_plain_ffbs_matches_jax_xla():
    T, M, N = 10, 16, 64
    pf_j, pf_t, kf = _models(N, jnp.float64)
    u = 0.3 * torch.ones(T, 1, dtype=torch.float64)
    _, _, y = llpt.simulate(kf, u, torch.Generator().manual_seed(1))
    # one forward pass for both packages (the port's, as JAX arrays)
    fwd = pf_t.forward_trajectory(u, y, generator=torch.Generator()
                                  .manual_seed(0))
    sol_j = llpf.ParticleFilteringSolution(**{
        f: jnp.asarray(getattr(fwd, f).numpy())
        for f in ("u", "y", "x", "w", "we", "ll")})
    key = jax.random.PRNGKey(5)
    xb_j, _ = llpf.ffbs_smooth(pf_j, sol_j, M, key, backend="xla")
    # JAX's draws from the same keys: the terminal resample, then one
    # Gumbel matrix per reversed step (categorical = argmax(g + logits))
    key, k0 = jax.random.split(key)
    j = np.asarray(jresample(sol_j.we[-1], k0, M, strategy="systematic"))
    gumbels = {}
    for t in range(T - 2, -1, -1):
        key, kd = jax.random.split(key)
        gumbels[t] = torch.tensor(np.asarray(
            jax.random.gumbel(kd, (M, N), jnp.float64)))
    sol_t = convert.particle_solution_from_numpy(sol_j, dtype=torch.float64,
                                                 device="cpu")
    xb_t = smoothing._ffbs_scan(pf_t, sol_t.x, sol_t.w, sol_t.u,
                                sol_t.x[-1][torch.tensor(j)], None,
                                gumbels.__getitem__)
    np.testing.assert_array_equal(xb_t.numpy(), np.asarray(xb_j))


def test_pf_smooth_routes_and_backends():
    """``pf.smooth`` and the ``smooth`` verb on CPU tensors take the plain
    loop; ``backend="kernel"`` raises where kernel J cannot run; the
    smoothed mean tracks the exact RTS smoother of the KF."""
    T, M, N = 30, 200, 500
    _, pf, kf = _models(N, jnp.float64)
    u = 0.3 * torch.ones(T, 1, dtype=torch.float64)
    _, _, y = llpt.simulate(kf, u, torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(0)
    xb, ll = llpt.smooth(pf, u, y, M=M, generator=g)
    assert llpt.last_route("smooth") == "ffbs_plain"
    assert xb.shape == (T, M, 2) and bool(torch.isfinite(ll))
    ssol = llpt.rts_smooth(llpt.forward_trajectory(kf, u, y), kf)
    z = (llpt.smoothed_mean(xb) - ssol.xT) / torch.diagonal(
        ssol.RT, dim1=-2, dim2=-1).sqrt()
    assert float(z.square().mean().sqrt()) < 0.5
    with pytest.raises(ValueError, match="kernel"):
        pf.smooth(u, y, M=M, generator=g, backend="kernel")
    with pytest.raises(ValueError, match="backend"):
        pf.smooth(u, y, M=M, generator=g, backend="pallas")
    with pytest.raises(TypeError, match="particle filter"):
        llpt.smooth(kf, u, y, M=M)
