"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py);
``chip_smoke.py`` takes its lattice case from here too.

Inputs are made with numpy from a seed and handed to both packages; JAX
runs on the CPU with x64 (tests/conftest.py), so every JAX array is built
with an explicit dtype.  Tests of the CUDA kernels take the
``cuda_device`` fixture and carry the ``cuda`` marker: they skip where
``torch.cuda.is_available()`` is false, decided when the test runs.
"""
import numpy as np
import pytest
import torch

# the benchmark's 2-state model (bench.py:389-393)
A = np.array([[0.97043, -0.097368], [0.097368, 0.970437]])
B = np.array([[0.1], [0.0]])
C = np.eye(2)
R1 = 0.01 * np.eye(2)
R2 = 0.1 * np.eye(2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def lattice_case(N, T, device=None, seed=0):
    """A no-noise filter whose resampling is exact in f32 in any sum order.

    States are multiples of 8 in 8 coordinates (four with 2 levels, four
    with 8), the dynamics is the identity, and step t measures the one
    coordinate that the one-hot ``u_t`` picks, with variance 1/(2π).  A
    particle that matches ``y_t`` (the track of particle 0) scores 0 on top
    of its weight, one that does not about -201, whose exp is 0 in f32.
    So every weight is 0 or 1 and every sum is an exact integer.  Each
    coordinate is revealed once and then all revealed ones are measured
    again, so a particle a gather put in the wrong slot dies there.  The
    threshold 1 - 0.5/N fires on every step where a particle dies and on
    no other.  Step 5 is missing (NaN).  Returns ``(pf, u, y, x0)``.
    """
    from lowlevelparticlefilters_jl_tpu_torch import convert

    rng = np.random.default_rng(seed)
    x0 = np.stack([8.0 * rng.integers(0, L, N)
                   for L in (2, 2, 2, 2, 8, 8, 8, 8)], 1)
    sched = []
    for i in range(8):
        sched += [i] + list(range(i + 1))
    sched = (sched + list(range(8)) * T)[:T]
    u = np.eye(8)[sched]
    y = x0[0, sched][:, None].copy()
    y[5] = np.nan
    pf = convert.particle_filter_from_numpy(
        N, lambda x, u, p, t: x, lambda x, u, p, t: (u @ x).reshape(1),
        np.eye(8), [[1 / (2 * np.pi)]], np.eye(8),
        resample_threshold=1 - 0.5 / N, device=device)
    return pf, *(torch.tensor(a, dtype=torch.float32, device=device)
                 for a in (u, y, x0))


def np_of(a) -> np.ndarray:
    """A JAX array or torch tensor as a float64 numpy array."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
    return np.asarray(a, dtype=np.float64)
