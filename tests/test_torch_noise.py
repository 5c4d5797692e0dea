"""PyTorch port: the Philox noise of kernels C and D, through their plain
twins here and against the kernels on the card."""
import math

import torch

from lowlevelparticlefilters_jl_tpu_torch.kernels import noise
from lowlevelparticlefilters_jl_tpu_torch.ops.linalg import chol_lower

# Random123 kat_vectors: philox4x32_10, counter 0, key 0
KAT = [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]


def test_philox_known_answer():
    ctr = torch.zeros(1, 4, dtype=torch.int64)
    assert noise.philox_bits(ctr, (0, 0))[0].tolist() == KAT


def test_philox_words_are_uint32_and_counter_sensitive():
    ctr = torch.tensor([[0, 0, 0, 0], [1, 0, 0, 0], [0, 0, 0, 1]])
    b = noise.philox_bits(ctr, (0xFFFFFFFF, 0x12345678))
    assert int(b.min()) >= 0 and int(b.max()) <= 0xFFFFFFFF
    assert len({tuple(r) for r in b.tolist()}) == 3


def test_normal_moments():
    n = 1 << 16
    z = noise.normal(1234, (n,), device="cpu").double()
    se = 1.0 / math.sqrt(n)
    assert abs(float(z.mean())) < 4 * se
    # the variance of a sample variance of normals is 2/n
    assert abs(float(z.var()) - 1.0) < 4 * math.sqrt(2.0) * se
    assert torch.equal(z, noise.normal(1234, (n,), device="cpu").double())
    assert not torch.equal(z, noise.normal(1235, (n,), device="cpu").double())


def test_normal_layout_matches_rows():
    """Element k of the flat stream is lane k % 4 of Philox row k // 4."""
    flat = noise.normal(7, (4, 5), step=3, device="cpu")
    rows = noise.normals_plain(7, noise.TAG_NORMAL, 3, 5, 4)
    assert torch.equal(flat.reshape(-1), rows.reshape(-1))


def test_add_gaussian_noise_plain():
    """Kernel D's xn form on CPU tensors: ``xn + z Lᵀ + mean`` with L the
    unrolled factor of the covariance, bit for bit."""
    g = torch.Generator().manual_seed(0)
    xn = torch.randn(1000, 3, generator=g)
    chol = torch.tensor([[1.0, 0.0, 0.0], [0.2, 0.6, 0.0], [0.0, 0.1, 0.5]])
    cov, mean = chol @ chol.T, torch.tensor([0.1, -0.2, 0.3])
    out = noise.add_gaussian_noise(xn, cov, mean, seed=99, step=4)
    z = noise.normals_plain(99, noise.TAG_PROPAGATE, 4, 1000, 3)
    torch.testing.assert_close(out, xn + z @ chol_lower(cov).T + mean,
                               rtol=0, atol=0)
