"""PyTorch port: kernel F's plain twin (kernels/bank_scan.py) against one
interpret-mode call of the JAX Pallas kernel ``bank_loglik_kernel`` at
B = 37, T = 8, float32, rtol 2e-5, atol 1e-4 (as
tests/test_bank_kernel.py holds the Pallas kernel: f32 sums in another
order).  Both start from their own package's shared recursion."""
import jax.numpy as jnp
import numpy as np
import torch
from _torch_parity import np_of

import lowlevelparticlefilters_jl_tpu as llpf
from lowlevelparticlefilters_jl_tpu.filters import bank as jbank
from lowlevelparticlefilters_jl_tpu.ops.pallas import bank_scan as jbs
from lowlevelparticlefilters_jl_tpu_torch import convert
from lowlevelparticlefilters_jl_tpu_torch.filters import bank as tbank
from lowlevelparticlefilters_jl_tpu_torch.kernels import bank_scan as tbs

A = np.array([[0.97, -0.1], [0.1, 0.97]])
B = np.array([[0.1], [0.0]])
C = np.array([[1.0, 0.0], [0.2, 1.0]])
D = np.array([[0.05], [0.0]])
R1, R2 = 0.01 * np.eye(2), 0.1 * np.eye(2)
D0M, D0C = np.array([0.1, -0.2]), 0.5 * np.eye(2)


def test_bank_twin_matches_pallas_kernel():
    Bk, T = 37, 8
    rng = np.random.default_rng(5)
    ys = rng.normal(size=(Bk, T, 2)).astype(np.float32)
    us = (0.3 * rng.normal(size=(Bk, T, 1))).astype(np.float32)
    f32 = np.float32
    kj = llpf.KalmanFilter(*(jnp.asarray(M, f32) for M in (A, B, C, D, R1,
                                                           R2)),
                           d0=llpf.MvNormal(jnp.asarray(D0M, f32),
                                            jnp.asarray(D0C, f32)))
    uj, yj, _, _ = jbank._bank_inputs(kj, jnp.asarray(us), jnp.asarray(ys))
    _, Sch, K, _, Am, Bm, Cm, Dm = jbank._shared_recursion(kj, T,
                                                           jnp.float32)
    want = jbs.bank_loglik_kernel(kj, uj, yj, Sch, K, Am, Bm, Cm, Dm)

    kt = convert.kalman_filter_from_numpy(A, B, C, D, R1, R2, D0M, D0C,
                                          dtype=torch.float32, device="cpu")
    ut, yt = torch.tensor(us), torch.tensor(ys)
    _, Sch, K, _, Am, Bm, Cm, Dm = tbank._shared_recursion(
        kt, T, torch.float32, "cpu")
    got = tbs.bank_loglik_kernel(kt, ut, yt, Sch, K, Am, Bm, Cm, Dm)
    np.testing.assert_allclose(np_of(got), np_of(want), rtol=2e-5, atol=1e-4)
    # the scalars' shape: S = nx² + 2 nx ny + ny² + nx nu + ny nu
    scal, _ = tbs.bank_scalars(Sch, K, Am, Bm, Cm, Dm, 1)
    assert scal.shape == (T, 4 + 8 + 4 + 2 + 2) and scal.dtype == torch.float32
