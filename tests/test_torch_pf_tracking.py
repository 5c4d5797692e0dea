"""PyTorch port: PF state tracking (trajectory.py, routing.py) against
the JAX package: ``mean_trajectory`` in its array and filter forms,
``weighted_quantile`` and ``mode_trajectory``, and the routes
``mean_trajectory`` records."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lowlevelparticlefilters_jl_tpu as llpf
import lowlevelparticlefilters_jl_tpu_torch as llpt
from lowlevelparticlefilters_jl_tpu_torch import convert
from _torch_parity import A, B, C, R2


@pytest.fixture(scope="module")
def cloud():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(6, 300, 3))
    x[:, 10:20] = x[:, :10]  # ties
    we = rng.random((6, 300)) ** 4
    return x, we / we.sum(-1, keepdims=True)


def test_array_forms_match_jax(cloud):
    x, we = cloud
    xt, wt = torch.tensor(x), torch.tensor(we)
    np.testing.assert_allclose(
        llpt.mean_trajectory(xt, wt).numpy(),
        np.asarray(llpf.mean_trajectory(jnp.asarray(x), jnp.asarray(we))),
        rtol=1e-12)
    np.testing.assert_array_equal(
        llpt.mode_trajectory(xt, wt).numpy(),
        np.asarray(llpf.mode_trajectory(jnp.asarray(x), jnp.asarray(we))))
    for q in (0.05, 0.5, 0.9):
        np.testing.assert_array_equal(
            llpt.weighted_quantile(xt, wt, q).numpy(),
            np.asarray(llpf.weighted_quantile(jnp.asarray(x),
                                              jnp.asarray(we), q)))


def test_filter_form_matches_jax():
    """A filter whose cloud has no spread (initial and process
    covariances 1e-12), so both packages' random streams give the same
    filtered means; on the CPU ``auto`` runs forward_trajectory,
    ``fused`` kernel A's twin in its moments mode."""
    T, tiny = 30, 1e-12 * np.eye(2)
    rng = np.random.default_rng(1)
    u = 0.3 * np.ones((T, 1))
    y = rng.normal(size=(T, 2))
    m0 = np.array([0.5, -0.3])
    Aj, Bj, Cj = (jnp.asarray(M) for M in (A, B, C))
    pj = llpf.ParticleFilter(
        N=64, dynamics=lambda x, u, p, t: Aj @ x + Bj @ u,
        measurement=lambda x, u, p, t: Cj @ x,
        dynamics_density=jnp.asarray(tiny), measurement_density=jnp.asarray(R2),
        initial_density=llpf.MvNormal(jnp.asarray(m0), jnp.asarray(tiny)))
    want = np.asarray(llpf.mean_trajectory(pj, jnp.asarray(u), jnp.asarray(y),
                                           key=jax.random.PRNGKey(0)))
    f, g = convert.linear_callbacks(A, B, C, device="cpu")
    pt = convert.particle_filter_from_numpy(64, f, g, tiny, R2, tiny,
                                            d0_mean=m0, device="cpu")
    ut, yt = torch.tensor(u, dtype=torch.float32), torch.tensor(
        y, dtype=torch.float32)
    for method, route in (("auto", "sequential"),
                          ("fused", "fused_scan_plain")):
        got = llpt.mean_trajectory(pt, ut, yt, method=method,
                                   generator=torch.Generator().manual_seed(0))
        assert llpt.last_route("mean_trajectory") == route
        assert got.shape == (T, 2)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_fused_route_needs_a_generator_and_the_filters_p():
    f, g = convert.linear_callbacks(A, B, C, device="cpu")
    pt = convert.particle_filter_from_numpy(64, f, g, 0.01 * np.eye(2), R2,
                                            np.eye(2), device="cpu")
    u, y = torch.full((5, 1), 0.3), torch.zeros(5, 2)
    gen = torch.Generator().manual_seed(0)
    for kw in (dict(generator=None), dict(generator=gen, p=object())):
        llpt.mean_trajectory(pt, u, y, method="fused", **kw)
        assert llpt.last_route("mean_trajectory") == "sequential"
    sol = pt.forward_trajectory(u, y, generator=torch.Generator()
                                .manual_seed(3))
    np.testing.assert_allclose(
        llpt.mean_trajectory(sol.x, sol.we).numpy(),
        llpt.weighted_mean(sol.x, sol.we).numpy())
