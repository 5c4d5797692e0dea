"""PyTorch port: the plain twin of kernel K's whole-element mode
(``kernels/assoc_scan.filter_scan_full``) against the JAX package's
``filter_scan_full`` (its XLA route off the TPU), float64: all five
combined element stacks ``(A, b, C, eta, J)``, rtol 1e-10."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lowlevelparticlefilters_jl_tpu.ops.pallas import assoc_scan as jas
from lowlevelparticlefilters_jl_tpu_torch.kernels import assoc_scan as tas


def _psd(rng, T, nx, scale):
    h = rng.normal(size=(T, nx, nx)) * 0.3
    return h @ np.swapaxes(h, -1, -2) + scale * np.eye(nx)


@pytest.mark.parametrize("nx,T", [(2, 64), (3, 37)])
def test_filter_scan_full_twin_matches_jax(nx, T):
    rng = np.random.default_rng(nx + T)
    el = (rng.normal(size=(T, nx, nx)) * 0.3, rng.normal(size=(T, nx)),
          _psd(rng, T, nx, 0.1), rng.normal(size=(T, nx)),
          _psd(rng, T, nx, 0.1))
    # under jit: eagerly the XLA scan dispatches op by op (seconds)
    want = jax.jit(jas.filter_scan_full)(*(jnp.asarray(a) for a in el))
    got = tas.filter_scan_full(*(torch.tensor(a) for a in el))
    assert [g.shape for g in got] == [a.shape for a in el]
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10,
                                   atol=1e-12)
