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
- The twin's Gumbel-max draws against the categorical law they sample.
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


def test_twin_gumbel_draws_sample_the_weights():
    """One step, 20000 trajectories from one backward state over four
    columns of log-weights w: the share of each column is softmax(w)
    within 4 standard errors; the noise is Gumbel(0, 1) (mean 0.5772),
    strictly finite, and differs between steps and trajectories."""
    M, N = 20000, 4
    w = torch.tensor([[0.0, -1.0, 0.5, -np.inf]])
    zpred = torch.zeros(1, N, 1)
    xf = torch.arange(N, dtype=torch.float32).reshape(1, N, 1)
    out, idx = ffbs.ffbs_backward_plain(
        zpred, w, torch.zeros(1, 1), xf, torch.zeros(M, 1),
        torch.ones(1, 1), torch.zeros(1), 11, return_indices=True)
    share = torch.bincount(idx[0].long(), minlength=N).double() / M
    p = torch.softmax(w[0].double(), 0)
    assert bool(((share - p).abs() <= 4 * (p * (1 - p) / M).sqrt()).all())
    g = ffbs.gumbel_plain(3, 2, 64, 4096)
    assert bool(torch.isfinite(g).all())
    assert abs(float(g.mean()) - 0.5772) < 0.01
    assert not torch.equal(g, ffbs.gumbel_plain(3, 1, 64, 4096))
    assert not torch.equal(g[0], g[1])


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
