"""PyTorch port: kernel D, the bootstrap PF's propagate step in one launch
(kernels/noise.py, routing.route_pf_propagate), through its plain twin on
the CPU.  The twin against the chain it replaces, the dynamics program the
kernel compiles against the JAX dynamics, the program's admission and
cache, and the unfused PF's ll through the new path against the JAX
particle filter and the KF.  The kernel itself is held to the twin on the
card (tests/test_torch_cuda.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import A, B, C, R1, R2

import lowlevelparticlefilters_jl_tpu as llpf
import lowlevelparticlefilters_jl_tpu_torch as llpt
from lowlevelparticlefilters_jl_tpu_torch import convert, routing
from lowlevelparticlefilters_jl_tpu_torch.filters.particle import PFState
from lowlevelparticlefilters_jl_tpu_torch.kernels import noise

A4 = 0.9 * np.eye(4) + 0.05 * np.roll(np.eye(4), 1, 0)


def _pf(case, N=500):
    """The benchmark's linear model (nu = 1), or ``A4 x + 0.01 sin x``
    (nu = 0), with kernel D's noise backend; a covariance with a zero
    variance (a zero pivot) for the singular case."""
    if case == "nonlinear":
        At = torch.tensor(A4, dtype=torch.float32)
        f = lambda x, u, p, t: At @ x + 0.01 * torch.sin(x)  # noqa: E731
        g = lambda x, u, p, t: x[:2]  # noqa: E731
        return convert.particle_filter_from_numpy(
            N, f, g, 0.01 * np.eye(4) + 0.002, R2, np.eye(4),
            R1_mean=0.1 * np.ones(4), noise_backend="kernel", device="cpu")
    f, g = convert.linear_callbacks(A, B, C, device="cpu")
    cov = np.diag([0.0, 0.01]) if case == "singular" else R1
    return convert.particle_filter_from_numpy(
        N, f, g, cov, R2, R1, R1_mean=[0.05, -0.02], noise_backend="kernel",
        device="cpu")


def _u(pf):
    return torch.full((1,), 0.3) if pf.nx == 2 else torch.zeros(0)


@pytest.mark.parametrize("case", ["linear", "nonlinear", "singular"])
def test_twin_equals_old_chain(case):
    """``pf.predict`` (no resampling) through the twin against the chain
    that ran before: ``vmap(f)``, the Philox normals times
    ``d1.chol()ᵀ``, then ``+ d1.mean``, from the same seed; within 1e-6
    (the same operations: bitwise), NaN in the same places for a singular
    covariance."""
    pf = _pf(case).replace(resample_threshold=0.0)
    x = torch.randn(pf.N, pf.nx, generator=torch.Generator().manual_seed(1))
    w, we = torch.full((pf.N,), -np.log(pf.N)), torch.full((pf.N,), 1 / pf.N)
    u, t, step = _u(pf), 3.0, 3
    st = PFState(x=x, w=w, we=we, t=step,
                 generator=torch.Generator().manual_seed(5))
    got = pf.predict(st, u, t=t).x
    assert routing.last_route("predict") == "propagate_plain"
    seed = routing.seed_from_generator(torch.Generator().manual_seed(5))
    d1 = pf.dynamics_density
    xn = torch.func.vmap(lambda xi: pf.dynamics(xi, u, None, t))(x)
    z = noise.normals_plain(seed, noise.TAG_PROPAGATE, step, pf.N, pf.nx)
    old = xn + z @ d1.chol().T + d1.mean
    assert torch.equal(got.isnan(), old.isnan())
    assert bool(got.isnan().any()) == (case == "singular")
    torch.testing.assert_close(got.nan_to_num(), old.nan_to_num(), rtol=0,
                               atol=1e-6)
    # the xn form's twin is the same function
    torch.testing.assert_close(
        noise.add_gaussian_noise(xn, d1.cov, d1.mean,
                                 torch.tensor(seed), step).nan_to_num(),
        got.nan_to_num(), rtol=0, atol=0)


def test_dynamics_program_matches_jax():
    """The program kernel D compiles (``Program.evaluate``, float64 in
    Python) against the JAX dynamics on the same numpy inputs."""
    rng = np.random.default_rng(0)
    for case, fj in (
            ("linear", lambda x, u, t: jnp.asarray(A) @ x
             + jnp.asarray(B) @ u),
            ("nonlinear", lambda x, u, t: jnp.asarray(A4) @ x
             + 0.01 * jnp.sin(x))):
        pf = _pf(case)
        nu = _u(pf).shape[0]
        comp = noise.propagate_program(pf, nu, "cpu")
        consts = comp.consts("cpu").double().tolist()
        for _ in range(4):
            x = rng.normal(size=pf.nx).astype(np.float32)
            u = rng.normal(size=nu).astype(np.float32)
            got = comp.prog.evaluate([x.tolist(), u.tolist(), [2.0]], consts)
            want = np.asarray(fj(jnp.asarray(x, jnp.float64),
                                 jnp.asarray(u, jnp.float64), 2.0))
            # the constants are the float32 matrices the filter holds
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_program_admission_and_cache():
    """A filter's dynamics lower once (cached per filter, input width and
    device); a callback that does not lower gives None, the xn form; an
    in-place change of a closed-over matrix reaches the constants."""
    pf = _pf("linear")
    comp = noise.propagate_program(pf, 1, "cpu")
    assert comp is not None and comp is noise.propagate_program(pf, 1, "cpu")
    src = comp.source()
    assert "#define LLPF_PROP_NX 2" in src and "void cb_f(" in src
    assert src.rstrip().endswith('#include "propagate.cuh"')
    c0 = comp.consts("cpu").clone()
    assert comp.consts("cpu") is comp.consts("cpu")
    At = comp.prog.consts[0]
    At.mul_(2.0)
    assert torch.equal(comp.consts("cpu")[:4], 2.0 * c0[:4])
    At.mul_(0.5)
    # data-dependent control flow does not trace: not admitted
    bad = pf.replace(dynamics=lambda x, u, p, t: x if float(x[0]) > 0
                     else -x)
    assert noise.propagate_program(bad, 1, "cpu") is None


def test_unfused_pf_ll_against_jax_pf_and_kf():
    """The unfused PF's ll through kernel D's twin
    (``noise_backend="kernel"``) and the JAX particle filter's ll, each
    within 2 % of the KF's (the bound of the port's other PF parity
    tests, at their model, size and data, tests/test_torch_slice.py)."""
    T, N = 50, 4000
    kf = convert.kalman_filter_from_numpy(A, B, C, 0, R1, R2, device="cpu")
    u = torch.full((T, 1), 0.3, dtype=torch.float64)
    _, u, y = llpt.simulate(kf, u, torch.Generator().manual_seed(1))
    ll_kf = float(llpt.loglik(kf, u, y))
    f, g = convert.linear_callbacks(A, B, C, device="cpu")
    pf = convert.particle_filter_from_numpy(N, f, g, R1, R2, R1,
                                            noise_backend="kernel",
                                            device="cpu")
    sol = pf.forward_trajectory(u.float(), y.float(),
                                generator=torch.Generator().manual_seed(2))
    assert routing.last_route("predict") == "propagate_plain"
    pj = llpf.ParticleFilter(
        N=N, dynamics=lambda x, u, p, t: jnp.asarray(A) @ x
        + jnp.asarray(B) @ u,
        measurement=lambda x, u, p, t: jnp.asarray(C) @ x,
        dynamics_density=jnp.asarray(R1), measurement_density=jnp.asarray(R2),
        initial_density=llpf.MvNormal(jnp.zeros(2), jnp.asarray(R1)))
    ll_jax = float(llpf.loglik(pj, jnp.asarray(u.numpy()),
                               jnp.asarray(y.numpy()),
                               key=jax.random.PRNGKey(0)))
    for ll in (float(sol.ll), ll_jax):
        assert abs(ll - ll_kf) < 0.02 * abs(ll_kf)
