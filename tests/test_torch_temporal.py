"""PyTorch port: the temporal-parallel Kalman filter and RTS smoother
(parallel/temporal.py) against the JAX package's, and the routes the KF
verbs take.

Parity runs in float64 on the CPU with rtol 1e-9, atol 1e-10: the same
formulas, but the port's Hillis–Steele scan associates the combines in
another order than ``jax.lax.associative_scan``, so rounding differs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import A, B, C, R1, R2, np_of

import lowlevelparticlefilters_jl_tpu as llpf
import lowlevelparticlefilters_jl_tpu_torch as llpt
from lowlevelparticlefilters_jl_tpu.parallel import temporal as jtp
from lowlevelparticlefilters_jl_tpu_torch import convert, routing
from lowlevelparticlefilters_jl_tpu_torch.kernels import _lib, noise

RTOL, ATOL = 1e-9, 1e-10
FIELDS = ("x", "xt", "R", "Rt", "e", "S", "K", "ll", "t", "ok")


def _case(nx, T, with_input):
    rng = np.random.default_rng(100 * nx + T)
    A_ = 0.9 * np.eye(nx) + 0.05 * rng.normal(size=(nx, nx))
    B_ = rng.normal(size=(nx, 1))
    C_ = rng.normal(size=(2, nx))
    R1_ = 0.01 * np.eye(nx) + 0.002 * np.ones((nx, nx))
    d0m, d0c = rng.normal(size=nx), 0.5 * np.eye(nx)
    kj = llpf.KalmanFilter(jnp.asarray(A_), jnp.asarray(B_), jnp.asarray(C_),
                           0, jnp.asarray(R1_), jnp.asarray(R2),
                           d0=llpf.MvNormal(jnp.asarray(d0m),
                                            jnp.asarray(d0c)))
    kt = convert.kalman_filter_from_numpy(A_, B_, C_, 0, R1_, R2, d0m, d0c,
                                          device="cpu")
    y = rng.normal(size=(T, 2))
    u = rng.normal(size=(T, 1)) if with_input else None
    return kj, kt, u, y


@pytest.mark.parametrize("with_input", [True, False])
@pytest.mark.parametrize("T", [1, 2, 37, 300])
@pytest.mark.parametrize("nx", [2, 3])
def test_parallel_filter_and_smoother_match_jax(nx, T, with_input):
    kj, kt, u, y = _case(nx, T, with_input)
    uj = None if u is None else jnp.asarray(u)
    ut = None if u is None else torch.tensor(u)
    sj = jtp.parallel_forward_trajectory(kj, uj, jnp.asarray(y))
    smj = jtp.parallel_rts_smooth(kj, uj, jnp.asarray(y), sol=sj)
    st = llpt.parallel_forward_trajectory(kt, ut, torch.tensor(y))
    smt = llpt.parallel_rts_smooth(kt, ut, torch.tensor(y))
    for f in FIELDS:
        np.testing.assert_allclose(np_of(getattr(st, f)),
                                   np_of(getattr(sj, f)), rtol=RTOL,
                                   atol=ATOL, err_msg=f)
    for f in ("xT", "RT"):
        np.testing.assert_allclose(np_of(getattr(smt, f)),
                                   np_of(getattr(smj, f)), rtol=RTOL,
                                   atol=ATOL, err_msg=f)
    assert st.route == "temporal_parallel_plain"
    assert smt.xt is smt.sol.xt


@pytest.mark.parametrize("nx", [2, 9])
def test_plane_and_array_pipelines_match_sequential(nx):
    """nx = 2 takes the plane pipeline, nx = 9 the batched arrays (which
    the verbs' gate keeps for direct calls); both equal the sequential
    filter, time-varying A included."""
    _, kt, u, y = _case(nx, 60, True)
    rng = np.random.default_rng(3)
    A_tv = np_of(kt.A) + 0.02 * rng.normal(size=(60, nx, nx))
    kt = kt.replace(A=torch.tensor(A_tv))
    ut, yt = torch.tensor(u), torch.tensor(y)
    seq = llpt.forward_trajectory(kt, ut, yt, method="sequential")
    par = llpt.parallel_forward_trajectory(kt, ut, yt)
    assert par.route == "temporal_parallel_plain"
    for f in ("x", "xt", "R", "Rt", "e", "S", "K", "ll"):
        np.testing.assert_allclose(np_of(getattr(par, f)),
                                   np_of(getattr(seq, f)), rtol=1e-8,
                                   atol=1e-11, err_msg=f)


def _headline(T=300):
    kt = convert.kalman_filter_from_numpy(A, B, C, 0, R1, R2, device="cpu")
    rng = np.random.default_rng(1)
    return (kt, torch.full((T, 1), 0.3, dtype=torch.float64),
            torch.tensor(0.3 * rng.normal(size=(T, 2))))


def test_verb_routes_on_cpu():
    """CPU tensors: auto is sequential; "parallel" takes the plane
    pipeline's Hillis–Steele scan (kernel K's twin) and gives the same
    ll; out of the gate (alpha != 1, one step) it stays sequential."""
    kt, u, y = _headline()
    ll_seq = llpt.loglik(kt, u, y)
    assert llpt.last_route("loglik") == "sequential"
    ll_par = llpt.loglik(kt, u, y, method="parallel")
    assert llpt.last_route("loglik") == "temporal_parallel_plain"
    np.testing.assert_allclose(float(ll_par), float(ll_seq), rtol=RTOL)
    sol = llpt.forward_trajectory(kt, u, y)
    assert sol.route == llpt.last_route() == "sequential"
    llpt.loglik(kt.replace(alpha=1.01), u, y, method="parallel")
    assert llpt.last_route("loglik") == "sequential"
    llpt.loglik(kt, u[:1], y[:1], method="parallel")
    assert llpt.last_route("loglik") == "sequential"


def test_vmap_takes_sequential_route():
    """Under torch.func.vmap the verbs take the sequential route (the
    batch guard), which vmap batches: the ll of each member equals its
    own call."""
    kt, u, y = _headline(40)
    ys = torch.stack([y, 0.5 * y, -y])
    lls = torch.func.vmap(
        lambda yi: llpt.loglik(kt, u, yi, method="parallel"))(ys)
    assert llpt.last_route("loglik") == "sequential"
    want = [float(llpt.loglik(kt, u, yi, method="parallel")) for yi in ys]
    np.testing.assert_allclose(lls.numpy(), want, rtol=1e-9)
    assert routing._under_batch_trace(kt, u, y) is False
    torch.func.vmap(lambda yi: routing.route_pf_loglik(
        None, u, yi, None, None, None, "fused") or yi.sum())(ys)
    assert llpt.last_route("loglik") == "sequential"


def test_default_device_is_the_card(monkeypatch):
    """Builders and noise.normal put tensors on the card unless told
    otherwise, and raise where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.kalman_filter_from_numpy(A, B, C, 0, R1, R2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.linear_callbacks(A, B, C)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.particle_filter_from_numpy(
            10, *convert.linear_callbacks(A, B, C, device="cpu"), R1, R2, R1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        noise.normal(0, (4,))
    assert _lib.default_device("cpu") == torch.device("cpu")
    assert noise.normal(0, (4,), device="cpu").device.type == "cpu"
