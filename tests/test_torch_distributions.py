"""PyTorch port: the scalar noise densities and their product
(ops/distributions.py) against the JAX package, float64."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lowlevelparticlefilters_jl_tpu as llpf
import lowlevelparticlefilters_jl_tpu_torch as llpt
from lowlevelparticlefilters_jl_tpu_torch import convert

FAMILIES = [
    ("Normal", (0.2, 0.7)),
    ("Uniform", (-1.0, 1.5)),
    ("Laplace", (0.1, 0.4)),
    ("StudentT", (3.5, -0.2, 0.6)),
    ("Binary", (0.0, 1.0, 0.3)),
    ("MixtureNormal", (0.85, 0.1, 0.3, -0.5, 3.0)),
]


def _points(name):
    x = np.random.default_rng(0).normal(scale=1.5, size=200)
    if name == "Binary":
        x[::3], x[1::3] = 0.0, 1.0 + 1e-7  # inside isclose's atol/rtol
    return x


@pytest.mark.parametrize("name,params", FAMILIES, ids=[f[0] for f in FAMILIES])
def test_logpdf_matches_jax(name, params):
    dj = getattr(llpf, name)(*params)
    dt = convert.density_from_numpy(dj, device="cpu")
    assert type(dt) is getattr(llpt, name)
    x = _points(name)
    want = np.asarray(dj.logpdf(jnp.asarray(x)))
    got = dt.logpdf(torch.tensor(x)).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-12)
    np.testing.assert_allclose(float(dt.mean), float(dj.mean), rtol=1e-12)


def test_tuple_product_and_tensor_parameters():
    """The product sums its components over the last axis; a tensor
    parameter gives the same density as the number."""
    comps = [llpf.StudentT(3.0, 0.0, 0.3), llpf.Laplace(0.0, 0.3),
             llpf.Uniform(-2.0, 2.0)]
    dj = llpf.TupleProduct(comps)
    dt = convert.density_from_numpy(dj, device="cpu")
    assert dt.dim == 3 and isinstance(dt, llpt.TupleProduct)
    x = np.random.default_rng(1).normal(size=(50, 3))
    np.testing.assert_allclose(dt.logpdf(torch.tensor(x)).numpy(),
                               np.asarray(dj.logpdf(jnp.asarray(x))),
                               rtol=1e-12)
    np.testing.assert_allclose(dt.mean.numpy(), np.asarray(dj.mean),
                               rtol=1e-12)
    tens = llpt.StudentT(torch.tensor(3.0, dtype=torch.float64), 0.0, 0.3)
    np.testing.assert_allclose(tens.logpdf(torch.tensor(x[:, 0])).numpy(),
                               dt.dists[0].logpdf(torch.tensor(x[:, 0]))
                               .numpy(), rtol=1e-15)


@pytest.mark.parametrize("name,params", FAMILIES, ids=[f[0] for f in FAMILIES])
def test_sample_moments(name, params):
    """Draws from the generator land on the family's mean (4 standard
    errors), in the parameters' dtype, reproducibly."""
    d = getattr(llpt, name)(*params)
    g = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    s = d.sample(g(), (20000,), dtype=torch.float64)
    assert s.shape == (20000,) and s.dtype == torch.float64
    assert torch.equal(s, d.sample(g(), (20000,), dtype=torch.float64))
    se = float(s.std()) / np.sqrt(s.numel())
    assert abs(float(s.mean()) - float(d.mean)) < 4 * se
    assert torch.isfinite(d.logpdf(s)).all()


def test_product_sample_shape():
    d = llpt.TupleProduct([llpt.Normal(), llpt.Binary(-1.0, 1.0, 0.2)])
    s = d.sample(torch.Generator().manual_seed(0), (7,))
    assert s.shape == (7, 2) and s.dtype == torch.get_default_dtype()
    assert bool(((s[:, 1] == -1.0) | (s[:, 1] == 1.0)).all())
