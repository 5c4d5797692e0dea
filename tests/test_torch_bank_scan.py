"""PyTorch port: kernel F's plain twin (kernels/bank_scan.py) against
interpret-mode calls of the JAX Pallas kernel ``bank_loglik_kernel``,
float32, rtol 2e-5, atol 1e-4 (as tests/test_bank_kernel.py holds the
Pallas kernel: f32 sums in another order).  The first test starts each
side from its own package's shared recursion at B = 37, T = 8; the
parametrised one gives both kernels the port's recursion, so that only
the kernels differ, over the twin's segments and chunks (T below 32,
T not a multiple of the chunks, several segments), the widths 1 and 4,
no input, a shared input and an open-loop A.  The twin also stays within
1e-4 of the float64 sequential bank path at T = 1000, a NaN in one
member's y leaves every other member's ll as it was, and a member's ll
does not depend on the size of its bank."""
import jax.numpy as jnp
import numpy as np
import pytest
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


def _model(nx, ny, nu, seed, radius=None):
    """A random KF of the given widths (numpy, float64); with ``radius``,
    A is a rotation scaled to that spectral radius (open loop)."""
    rng = np.random.default_rng(seed)
    if radius is None:
        A_ = 0.9 * np.linalg.qr(rng.normal(size=(nx, nx)))[0]
    else:
        th = 0.1
        A_ = radius * np.array([[np.cos(th), -np.sin(th)],
                                [np.sin(th), np.cos(th)]])
    B_ = 0.2 * rng.normal(size=(nx, nu)) if nu else None
    C_ = rng.normal(size=(ny, nx))
    D_ = 0.05 * rng.normal(size=(ny, nu)) if nu else 0
    G1, G2 = rng.normal(size=(nx, nx)), rng.normal(size=(ny, ny))
    R1_ = 0.01 * (G1 @ G1.T + nx * np.eye(nx))
    R2_ = 0.1 * (G2 @ G2.T + ny * np.eye(ny))
    return A_, B_, C_, D_, R1_, R2_, 0.3 * rng.normal(size=nx), np.eye(nx)


# (T, nx, ny, nu, shared input, open loop, lane steps): T = 1, 8, 31 run
# one step a lane; 33 three (11 chunks), or one in two segments, the last
# of one step; 200 seven (29 chunks, the last of 4 steps), or three in
# three segments, the last of 8 steps.  A forced L reuses the JAX result
# of the same model and data (_WANT): the interpret-mode call takes 1-3 s
# on the CPU.
_CASES = [(1, 2, 2, 1, False, False, None),
          (8, 2, 2, 1, False, False, None),
          (31, 2, 2, 1, False, False, None),
          (33, 2, 2, 1, False, False, None),
          (33, 2, 2, 1, False, False, 1),
          (200, 2, 2, 1, False, False, None),
          (200, 2, 2, 1, False, False, 3),
          (33, 1, 1, 1, False, False, None),
          (33, 4, 4, 4, False, False, None),
          (33, 2, 2, 0, False, False, None),
          (33, 2, 2, 1, True, False, None),
          (200, 2, 2, 1, False, True, 3)]


_WANT = {}


@pytest.mark.parametrize("T,nx,ny,nu,shared,open_loop,L", _CASES)
def test_bank_chunked_twin_matches_pallas_kernel(monkeypatch, T, nx, ny, nu,
                                                 shared, open_loop, L):
    # the Pallas kernel's rolled loop of 8-step blocks, as
    # tests/test_bank_kernel.py runs it: a full unroll of 200 steps takes
    # minutes to trace in interpret mode
    monkeypatch.setattr(jbs, "_FULL_UNROLL", 8)
    monkeypatch.setattr(jbs, "_UNROLL", 8)
    Bk = 13
    A_, B_, C_, D_, R1_, R2_, m0, P0 = _model(
        nx, ny, nu, seed=100 * nx + 10 * nu + T,
        radius=1.02 if open_loop else None)
    rng = np.random.default_rng(T + nu)
    ys = rng.normal(size=(Bk, T, ny)).astype(np.float32)
    u1 = (0.3 * rng.normal(size=(1 if shared else Bk, T, nu))).astype(
        np.float32)
    us = np.broadcast_to(u1, (Bk, T, nu))
    kt = convert.kalman_filter_from_numpy(A_, B_, C_, D_, R1_, R2_, m0, P0,
                                          dtype=torch.float32, device="cpu")
    _, Sch, K, _, Am, Bm, Cm, Dm = tbank._shared_recursion(
        kt, T, torch.float32, "cpu")
    ut = (torch.tensor(u1[0])[None].expand(Bk, T, nu) if shared
          else torch.tensor(u1))
    if L is None:
        got = tbs.bank_loglik_kernel(kt, ut, torch.tensor(ys), Sch, K, Am,
                                     Bm, Cm, Dm)
    else:  # a forced chunk length: the scan's entry point
        scal, cst = tbs.bank_scalars(Sch, K, Am, Bm, Cm, Dm, nu)
        got = tbs.bank_loglik_scan(scal, torch.tensor(ys), ut,
                                   kt.d0.mean.float(), nx, ny, nu,
                                   _lane_steps=L) + cst.float()

    key = (T, nx, ny, nu, shared, open_loop)
    if key not in _WANT:
        f32 = np.float32
        kj = llpf.KalmanFilter(
            *(jnp.asarray(M, f32)
              for M in (A_, B_ if nu else np.zeros((nx, 0)), C_,
                        D_ if nu else np.zeros((ny, 0)), R1_, R2_)),
            d0=llpf.MvNormal(jnp.asarray(m0, f32), jnp.asarray(P0, f32)))
        j = lambda t: jnp.asarray(np_of(t), f32)  # noqa: E731
        _WANT[key] = np_of(jbs.bank_loglik_kernel(
            kj, jnp.asarray(us), jnp.asarray(ys), j(Sch), j(K), j(Am),
            j(Bm), j(Cm), j(Dm)))
    np.testing.assert_allclose(np_of(got), _WANT[key], rtol=2e-5, atol=1e-4)


def test_bank_twin_long_record_matches_f64_sequential():
    """At T = 1000 (five segments of 224 steps, the last of 104) the
    twin's ll is within 1e-4 relative of the float64 sequential bank
    recursion."""
    Bk, T = 24, 1000
    rng = np.random.default_rng(11)
    ys = rng.normal(size=(Bk, T, 2))
    us = 0.3 * rng.normal(size=(Bk, T, 1))
    k64 = convert.kalman_filter_from_numpy(A, B, C, D, R1, R2, D0M, D0C,
                                           dtype=torch.float64, device="cpu")
    want, *_ = tbank._bank_scan(k64, torch.tensor(us), torch.tensor(ys),
                                want_states=True)
    k32 = convert.kalman_filter_from_numpy(A, B, C, D, R1, R2, D0M, D0C,
                                           dtype=torch.float32, device="cpu")
    got = tbank.kf_bank_loglik(k32, torch.tensor(us, dtype=torch.float32),
                               torch.tensor(ys, dtype=torch.float32),
                               method="kernel")
    assert tbs.bank_plan(T, 2, 2, 1) == 7
    rel = ((got.double() - want).abs() / want.abs()).max()
    assert rel < 1e-4, rel


def test_bank_twin_nan_stays_in_its_member():
    """A NaN in one member's y makes that member's ll NaN and leaves every
    other member's ll bit for bit as it was (several segments)."""
    Bk, T = 9, 300
    rng = np.random.default_rng(12)
    ys = torch.tensor(rng.normal(size=(Bk, T, 2)), dtype=torch.float32)
    us = torch.tensor(0.3 * rng.normal(size=(Bk, T, 1)), dtype=torch.float32)
    kt = convert.kalman_filter_from_numpy(A, B, C, D, R1, R2, D0M, D0C,
                                          dtype=torch.float32, device="cpu")
    before = tbank.kf_bank_loglik(kt, us, ys, method="kernel")
    ys[4, 77, 1] = float("nan")
    after = tbank.kf_bank_loglik(kt, us, ys, method="kernel")
    assert torch.isnan(after[4]) and torch.isfinite(before).all()
    keep = torch.arange(Bk) != 4
    assert torch.equal(after[keep], before[keep])


def test_bank_twin_member_independent_of_bank():
    """A member's ll is the same, bit for bit, in banks of 3, 13 and 4096
    members (the chunk length depends on T and the widths only)."""
    T = 70
    rng = np.random.default_rng(13)
    ys = torch.tensor(rng.normal(size=(4096, T, 2)), dtype=torch.float32)
    us = torch.tensor(0.3 * rng.normal(size=(4096, T, 1)),
                      dtype=torch.float32)
    kt = convert.kalman_filter_from_numpy(A, B, C, D, R1, R2, D0M, D0C,
                                          dtype=torch.float32, device="cpu")
    whole = tbank.kf_bank_loglik(kt, us, ys, method="kernel")
    for Bk in (3, 13):
        part = tbank.kf_bank_loglik(kt, us[:Bk], ys[:Bk], method="kernel")
        assert torch.equal(part, whole[:Bk])
