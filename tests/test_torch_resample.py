"""PyTorch port: systematic resampling against the JAX package.

The slot boundaries K must equal JAX's bit for bit in float64 given the
same offset r (drawn here with ``jax.random.uniform`` from the key JAX
uses, and handed to the port), and the gathered particles must equal
``x[resample_systematic(we, key)]`` exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lowlevelparticlefilters_jl_tpu.ops import resample as jrs
from lowlevelparticlefilters_jl_tpu_torch.ops import resample as trs

N = 4096


def _weights(kind, seed=0, n=N):
    rng = np.random.default_rng(seed)
    we = np.ones(n) if kind == "uniform" else rng.uniform(size=n) ** 20
    return we / we.sum()


def _r(key):
    return float(jax.random.uniform(key, (), dtype=jnp.float64))


@pytest.mark.parametrize("kind", ["uniform", "skewed"])
@pytest.mark.parametrize("seed", [0, 1])
def test_systematic_slots_bitwise(kind, seed):
    we = _weights(kind, seed)
    key = jax.random.PRNGKey(seed)
    Kj = np.asarray(jrs._systematic_slots(jnp.asarray(we), key, N))
    Kt = trs._systematic_slots(torch.tensor(we), torch.tensor(_r(key),
                                                              dtype=torch.float64), N)
    assert Kt.dtype == torch.int32
    np.testing.assert_array_equal(Kt.numpy(), Kj)
    assert bool((Kt[1:] >= Kt[:-1]).all())


@pytest.mark.parametrize("kind", ["uniform", "skewed"])
def test_resample_systematic_indices(kind):
    we = _weights(kind, 3)
    key = jax.random.PRNGKey(3)
    jj = np.asarray(jrs.resample_systematic(jnp.asarray(we), key))
    jt = trs.resample_systematic(torch.tensor(we), r=torch.tensor(
        _r(key), dtype=torch.float64))
    np.testing.assert_array_equal(jt.numpy(), jj)


@pytest.mark.parametrize("kind", ["uniform", "skewed"])
@pytest.mark.parametrize("nx", [2, 4])
def test_gather_matches_jax(kind, nx):
    rng = np.random.default_rng(nx)
    we = _weights(kind, 5)
    x = rng.normal(size=(N, nx))
    key = jax.random.PRNGKey(5)
    xj = np.asarray(jnp.asarray(x)[jrs.resample_systematic(jnp.asarray(we),
                                                          key)])
    xt = trs.resample_systematic_gather(torch.tensor(x), torch.tensor(we),
                                        r=torch.tensor(_r(key),
                                                       dtype=torch.float64))
    np.testing.assert_array_equal(xt.numpy(), xj)


def test_other_strategies_are_valid_samplers():
    we = torch.tensor(_weights("skewed", 7, 1000))
    g = torch.Generator().manual_seed(0)
    for strat in ("systematic", "stratified", "residual", "multinomial"):
        j = trs.resample(we, g, strategy=strat)
        assert j.shape == (1000,)
        assert int(j.min()) >= 0 and int(j.max()) < 1000
        # every heavy particle (we > 2/N) is drawn by the low-variance
        # schemes
        if strat != "multinomial":
            heavy = torch.nonzero(we > 2.0 / 1000).flatten()
            assert set(heavy.tolist()) <= set(j.tolist())
    with pytest.raises(ValueError):
        trs.resample(we, g, strategy="nope")
