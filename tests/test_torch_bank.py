"""PyTorch port: the shared-Riccati KF bank (filters/bank.py) and the
vmapped banks (parallel/bank.py) against the JAX package, and the bank's
routes.

Parity runs in float64 on the CPU with rtol 1e-9: the same formulas (the
plane path's Hillis–Steele scan associates in another order than
``jax.lax.associative_scan``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import np_of

import lowlevelparticlefilters_jl_tpu as llpf
import lowlevelparticlefilters_jl_tpu_torch as llpt
from lowlevelparticlefilters_jl_tpu.filters import bank as jbank
from lowlevelparticlefilters_jl_tpu_torch import convert
from lowlevelparticlefilters_jl_tpu_torch.filters import bank as tbank

A = np.array([[0.97, -0.1], [0.1, 0.97]])
B = np.array([[0.1], [0.0]])
C = np.array([[1.0, 0.0], [0.2, 1.0]])
D = np.array([[0.05], [0.0]])
R1, R2 = 0.01 * np.eye(2), 0.1 * np.eye(2)
R12 = np.array([[0.01, 0.0], [0.0, 0.005]])
D0M, D0C = np.array([0.1, -0.2]), 0.5 * np.eye(2)
T = 8
RTOL = 1e-9


def _both(nu=1, R12_=None, alpha=1.0):
    Bm, Dm = (B, D) if nu else (None, None)
    kj = llpf.KalmanFilter(
        jnp.asarray(A), None if Bm is None else jnp.asarray(Bm),
        jnp.asarray(C), None if Dm is None else jnp.asarray(Dm),
        jnp.asarray(R1), jnp.asarray(R2),
        R12=None if R12_ is None else jnp.asarray(R12_), alpha=alpha,
        d0=llpf.MvNormal(jnp.asarray(D0M), jnp.asarray(D0C)))
    kt = llpt.KalmanFilter(
        torch.tensor(A), None if Bm is None else torch.tensor(Bm),
        torch.tensor(C), None if Dm is None else torch.tensor(Dm),
        torch.tensor(R1), torch.tensor(R2),
        R12=None if R12_ is None else torch.tensor(R12_), alpha=alpha,
        d0=llpt.MvNormal(torch.tensor(D0M), torch.tensor(D0C)))
    return kj, kt


def _data(Bk, nu, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    ys = rng.normal(size=(Bk, T, 2)).astype(dtype)
    us = (0.3 * rng.normal(size=(Bk, T, nu))).astype(dtype) if nu else None
    return us, ys


CASES = {"B1-nu0": (1, 0, {}), "B1-nu1": (1, 1, {}),
         "B37-nu0": (37, 0, {}), "B37-nu1": (37, 1, {}),
         "R12": (37, 1, {"R12_": R12}), "alpha": (37, 1, {"alpha": 1.02})}


@pytest.mark.parametrize("case", list(CASES))
def test_bank_matches_jax(case):
    """kf_bank_loglik (plane), kf_bank_forward and _shared_recursion
    against the JAX package's; the first three members also against the
    port's sequential loglik.  R12 and alpha take the shared recursion's
    general branch."""
    Bk, nu, kw = CASES[case]
    kj, kt = _both(nu, **kw)
    us, ys = _data(Bk, nu, seed=Bk + nu)
    uj = None if us is None else jnp.asarray(us)
    ut = None if us is None else torch.tensor(us)
    yj, yt = jnp.asarray(ys), torch.tensor(ys)
    ll = tbank.kf_bank_loglik(kt, ut, yt, method="plane")
    assert llpt.last_route("kf_bank_loglik") == "bank_plane"
    np.testing.assert_allclose(
        np_of(ll), np_of(jbank.kf_bank_loglik(kj, uj, yj, method="plane")),
        rtol=RTOL)
    fj, ft = jbank.kf_bank_forward(kj, uj, yj), tbank.kf_bank_forward(
        kt, ut, yt)
    for f in ("x", "xt", "R", "Rt", "ll", "e"):
        np.testing.assert_allclose(np_of(getattr(ft, f)),
                                   np_of(getattr(fj, f)), rtol=RTOL,
                                   atol=1e-12, err_msg=f)
    rj = jbank._shared_recursion(kj, T, jnp.float64)
    rt = tbank._shared_recursion(kt, T, torch.float64, "cpu")
    for a, b in zip(rt, rj):
        np.testing.assert_allclose(np_of(a), np_of(b), rtol=RTOL,
                                   atol=1e-12)
    seq = [float(llpt.loglik(kt, None if us is None else ut[b], yt[b],
                             method="sequential")) for b in range(min(Bk, 3))]
    np.testing.assert_allclose(np_of(ll)[:3], seq, rtol=RTOL)


def _kf32():
    return convert.kalman_filter_from_numpy(A, B, C, D, R1, R2, D0M, D0C,
                                            dtype=torch.float32, device="cpu")


def test_bank_routes_on_cpu():
    """auto on CPU tensors is the plane path; "kernel" runs kernel F's
    plain twin and agrees with it; outside F's gate "kernel" raises."""
    us, ys = (torch.tensor(a) for a in _data(300, 1, dtype=np.float32))
    kf = _kf32()
    ll_plane = tbank.kf_bank_loglik(kf, us, ys)
    assert llpt.last_route("kf_bank_loglik") == "bank_plane"
    ll_kern = tbank.kf_bank_loglik(kf, us, ys, method="kernel")
    assert llpt.last_route("kf_bank_loglik") == "bank_kernel_plain"
    np.testing.assert_allclose(ll_kern.numpy(), ll_plane.numpy(), rtol=2e-5,
                               atol=1e-4)
    with pytest.raises(ValueError, match="unsupported"):
        tbank.kf_bank_loglik(kf, us.double(), ys.double(), method="kernel")
    kf5 = convert.kalman_filter_from_numpy(
        np.eye(5) * 0.9, np.ones((5, 1)), np.ones((2, 5)), 0, np.eye(5),
        R2, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="unsupported"):
        tbank.kf_bank_loglik(kf5, us, ys, method="kernel")
    with pytest.raises(ValueError, match="unknown bank method"):
        tbank.kf_bank_loglik(kf, us, ys, method="nope")


def test_bank_batch_guard_and_vmap_fallback():
    """Under torch.func.vmap, method="kernel" takes the plane route (the
    batch guard); a filter out of the bank's admission (alpha a tensor)
    runs vmap over the sequential loglik."""
    us, ys = (torch.tensor(a) for a in _data(5, 1, dtype=np.float32))
    kf = _kf32()
    stacked = torch.stack([ys, 2.0 * ys])
    lls = torch.func.vmap(lambda y: tbank.kf_bank_loglik(
        kf, us, y, method="kernel"))(stacked)
    assert llpt.last_route("kf_bank_loglik") == "bank_plane"
    for i in range(2):
        np.testing.assert_allclose(
            lls[i].numpy(), tbank.kf_bank_loglik(kf, us, stacked[i]).numpy(),
            rtol=1e-6)
    kfa = kf.replace(alpha=torch.tensor(1.0))
    ll = tbank.kf_bank_loglik(kfa, us, ys)
    assert llpt.last_route("kf_bank_loglik") == "bank_vmap"
    np.testing.assert_allclose(ll.numpy(), tbank.kf_bank_loglik(
        kf, us, ys).numpy(), rtol=1e-5)
    with pytest.raises(ValueError):
        tbank.kf_bank_forward(kfa, us, ys)


def test_vmapped_banks_match_loops():
    _, kt = _both(1)
    us, ys = (torch.tensor(a) for a in _data(4, 1))
    ll = llpt.bank_loglik(kt, us, ys)
    sol = llpt.bank_forward_trajectory(kt, us, ys)
    for b in range(4):
        one = llpt.forward_trajectory(kt, us[b], ys[b])
        np.testing.assert_allclose(float(ll[b]), float(one.ll), rtol=1e-12)
        for f in ("x", "xt", "R", "Rt", "e", "K", "S"):
            np.testing.assert_allclose(np_of(getattr(sol, f)[b]),
                                       np_of(getattr(one, f)), rtol=1e-12,
                                       err_msg=f)
    shared = llpt.bank_loglik(kt, us[0], ys, in_axes=(None, None, 0))
    np.testing.assert_allclose(float(shared[1]), float(llpt.loglik(
        kt, us[0], ys[1])), rtol=1e-12)
    with pytest.raises(NotImplementedError):
        llpt.bank_loglik(kt, us, ys, in_axes=(0, 0, 0))
