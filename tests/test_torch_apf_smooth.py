"""PyTorch port: an auxiliary particle filter's ``smooth`` smooths its
own forward pass, as in the JAX package (where ``smooth`` lives on the
common particle base), and not the inner bootstrap filter's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lowlevelparticlefilters_jl_tpu as llpf
import lowlevelparticlefilters_jl_tpu_torch as llpt
from lowlevelparticlefilters_jl_tpu_torch import convert
from _torch_parity import A, B, C, R1, R2

T, N, M = 30, 300, 50


@pytest.fixture(scope="module")
def data():
    kf = convert.kalman_filter_from_numpy(A, B, C, 0, R1, R2, d0_cov=R1,
                                          device="cpu")
    u = torch.full((T, 1), 0.3, dtype=torch.float64)
    _, u, y = llpt.simulate(kf, u, torch.Generator().manual_seed(1))
    return u, y


def test_apf_smooth_smooths_its_own_forward_pass(data):
    """Under one generator the APF's ``smooth`` ll equals its own
    ``forward_trajectory`` ll and differs from the inner filter's."""
    u, y = data
    f, g = convert.linear_callbacks(A, B, C, dtype=torch.float64,
                                    device="cpu")
    pf = convert.particle_filter_from_numpy(
        N, f, g, R1, R2, R1, resample_threshold=0.5, dtype=torch.float64,
        device="cpu")
    apf = llpt.AuxiliaryParticleFilter(pf=pf)

    def gen():
        return torch.Generator().manual_seed(6)

    xb, ll = apf.smooth(u, y, M=M, generator=gen())
    ll_apf = apf.forward_trajectory(u, y, generator=gen()).ll
    ll_inner = pf.forward_trajectory(u, y, generator=gen()).ll
    assert xb.shape == (T, M, 2) and bool(torch.isfinite(xb).all())
    assert float(ll) == float(ll_apf)
    assert float(ll) != float(ll_inner)


def test_apf_smooth_identity_in_jax(data):
    """The JAX package's counterpart: ``apf.smooth`` under one key returns
    the ll of ``apf.forward_trajectory`` under the first half of that
    key's split, not the inner filter's."""
    u, y = data
    uj, yj = jnp.asarray(u.numpy()), jnp.asarray(y.numpy())
    Aj, Bj, R1j, R2j = (jnp.asarray(X) for X in (A, B, R1, R2))
    pf = llpf.ParticleFilter(
        N=N, dynamics=lambda x, u, p, t: Aj @ x + Bj @ u,
        measurement=lambda x, u, p, t: x, dynamics_density=R1j,
        measurement_density=R2j, initial_density=R1j, resample_threshold=0.5)
    apf = llpf.AuxiliaryParticleFilter(pf=pf)
    key = jax.random.PRNGKey(6)
    _, ll = apf.smooth(uj, yj, M=M, key=key)
    kf_, _ = jax.random.split(key)
    ll_apf = apf.forward_trajectory(uj, yj, key=kf_).ll
    ll_inner = pf.forward_trajectory(uj, yj, key=kf_).ll
    assert float(ll) == float(ll_apf)
    assert float(ll) != float(ll_inner)
    assert np.isfinite(float(ll))
