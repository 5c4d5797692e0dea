"""PyTorch port: ``utils/analysis.py`` against the JAX package on the same
numpy inputs in float64, rtol 1e-10.

- ``dare``, ``kalman_gain`` (of matrices and of a filter), ``dlyap`` and
  ``covar`` on the benchmark's 2-state model and the constant-velocity
  model (the same fixed iteration counts, so the same truncation);
- ``linearize`` of a KF (its matrices resolved) and of the quadtank UKF
  (``torch.func.jacfwd`` against ``jax.jacfwd``), ``obsv``/``ctrb``,
  ``observability`` and ``controllability`` (also from the noise input of
  an augmented-dynamics UKF);
- ``kalman_filter_from_ss``: tensors kept where they are, arrays sent to
  the named device (the card unless named: it raises without one);
- arrays given to ``dare``, ``dlyap``, ``obsv`` and ``linearize`` go to
  the device of the tensors among the inputs (a filter's), else to the
  card: without one that raises.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import A, B, C, R1, R2, np_of

import lowlevelparticlefilters_jl_tpu as llpf
import lowlevelparticlefilters_jl_tpu_torch as llpt
from lowlevelparticlefilters_jl_tpu_torch import convert

RTOL = dict(rtol=1e-10, atol=1e-12)
CV_A = np.array([[1, 0, 0.1, 0], [0, 1, 0, 0.1], [0, 0, 1, 0],
                 [0, 0, 0, 1.0]])
CV_B = np.array([[0.005], [0.0], [0.1], [0.0]])
CV_C = np.array([[1, 0, 0, 0], [0, 1, 0, 0.0]])
MODELS = {"benchmark": (A, B, C, R1, R2),
          "cv": (CV_A, CV_B, CV_C, 0.1 * np.eye(4), np.eye(2))}


def _pair(name):
    Am, Bm, Cm, Q, R = MODELS[name]
    kj = llpf.KalmanFilter(*(jnp.asarray(M) for M in (Am, Bm, Cm)), 0,
                           jnp.asarray(Q), jnp.asarray(R))
    kt = convert.kalman_filter_from_numpy(Am, Bm, Cm, 0, Q, R, device="cpu")
    return kj, kt


def _close(got, want, what=""):
    np.testing.assert_allclose(np_of(got), np_of(want), **RTOL,
                               err_msg=what)


@pytest.mark.parametrize("name", list(MODELS))
def test_riccati_lyapunov_gain_covar_match_jax(name):
    Am, Bm, Cm, Q, R = MODELS[name]
    jm = [jnp.asarray(M) for M in (Am, Cm, Q, R)]
    tm = [torch.tensor(M) for M in (Am, Cm, Q, R)]
    kj, kt = _pair(name)
    x, u = np.zeros(Am.shape[0]), np.zeros(1)
    # dlyap reads its doubling count eagerly: it and covar run outside jit
    want = jax.jit(lambda a, c, q, r: (
        llpf.dare(a, c, q, r),
        llpf.kalman_gain(a, C=c, R1=q, R2=r),
        llpf.kalman_gain(kj, x, u)))(*jm)
    want = (*want[:2], llpf.dlyap(jm[0], jm[2]), want[2],
            llpf.covar(kj, x, u))
    got = (llpt.dare(*tm), llpt.kalman_gain(tm[0], C=tm[1], R1=tm[2],
                                            R2=tm[3]),
           llpt.dlyap(tm[0], tm[2]),
           llpt.kalman_gain(kt, torch.tensor(x), torch.tensor(u)),
           llpt.covar(kt, torch.tensor(x), torch.tensor(u)))
    for what, g, w in zip(("dare", "gain", "dlyap", "gain(f)", "covar"),
                          got, want):
        assert g.dtype == torch.float64 and g.device.type == "cpu"
        _close(g, w, what)


def _quadtank(xp):
    g1 = lambda x: xp.sqrt(xp.abs(x) + 0.1)  # noqa: E731
    stack = xp.stack

    def dyn(x, u, p, t):
        return x + 0.1 * stack([-g1(x[0]) + 0.5 * g1(x[1]),
                                -0.5 * g1(x[1]) + 0.1])

    return dyn, lambda x, u, p, t: x[:1] * x


def test_linearize_kf_and_quadtank_ukf_match_jax():
    kj, kt = _pair("benchmark")
    x0, u0 = np.array([0.3, -0.2]), np.array([0.5])
    for g, w in zip(llpt.linearize(kt, torch.tensor(x0), torch.tensor(u0)),
                    llpf.linearize(kj, jnp.asarray(x0), jnp.asarray(u0))):
        assert (g is None) == (w is None)
        if w is not None:
            _close(g, w)
    fj, hj = _quadtank(jnp)
    ft, ht = _quadtank(torch)
    uj = llpf.make_ukf(fj, hj, 1e-3 * jnp.eye(2), 1e-2 * jnp.eye(2), ny=2,
                       nu=0)
    ut = llpt.make_ukf(ft, ht, 1e-3 * torch.eye(2, dtype=torch.float64),
                       1e-2 * torch.eye(2, dtype=torch.float64), ny=2, nu=0)
    xq = np.array([1.3, 0.7])
    want = jax.jit(lambda x: llpf.linearize(uj, x, jnp.zeros(0)))(
        jnp.asarray(xq))
    got = llpt.linearize(ut, torch.tensor(xq),
                         torch.zeros(0, dtype=torch.float64))
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        _close(g, w)


def test_observability_controllability_match_jax():
    kj, kt = _pair("cv")
    x, u = np.zeros(4), np.zeros(1)
    for fn in ("observability", "controllability"):
        w = getattr(llpf, fn)(kj, jnp.asarray(x), jnp.asarray(u))
        g = getattr(llpt, fn)(kt, torch.tensor(x), torch.tensor(u))
        assert {k: v for k, v in g.items() if k != "matrix"} == {
            k: v for k, v in w.items() if k != "matrix"}, fn
        _close(g["matrix"], w["matrix"], fn)
    _close(llpt.obsv(torch.tensor(CV_A), torch.tensor(CV_C), 2),
           llpf.obsv(jnp.asarray(CV_A), jnp.asarray(CV_C), 2))
    _close(llpt.ctrb(torch.tensor(CV_A), torch.tensor(CV_B)),
           llpf.ctrb(jnp.asarray(CV_A), jnp.asarray(CV_B)))
    # reachability from the noise of an augmented-dynamics UKF: w enters
    # the velocities only
    G = np.array([[0, 0], [0, 0], [1.0, 0], [0, 1.0]])
    Aj, Gj, At, Gt = (jnp.asarray(CV_A), jnp.asarray(G), torch.tensor(CV_A),
                      torch.tensor(G))
    uj = llpf.make_ukf(lambda x, u, p, t, w: Aj @ x + Gj @ w,
                       lambda x, u, p, t: x[:2], 0.1 * jnp.eye(2),
                       jnp.eye(2), d0=llpf.MvNormal(jnp.zeros(4),
                                                    jnp.eye(4)),
                       ny=2, nu=0, augmented_dynamics=True, nw=2)
    ut = llpt.make_ukf(lambda x, u, p, t, w: At @ x + Gt @ w,
                       lambda x, u, p, t: x[:2],
                       0.1 * torch.eye(2, dtype=torch.float64),
                       torch.eye(2, dtype=torch.float64),
                       d0=llpt.MvNormal(torch.zeros(4, dtype=torch.float64),
                                        torch.eye(4, dtype=torch.float64)),
                       ny=2, nu=0, augmented_dynamics=True, nw=2)
    w = llpf.controllability(uj, jnp.zeros(4), jnp.zeros(0), from_noise=True)
    g = llpt.controllability(ut, torch.zeros(4, dtype=torch.float64),
                             torch.zeros(0, dtype=torch.float64),
                             from_noise=True)
    assert g["rank"] == w["rank"] == 4 and g["iscontrollable"]
    _close(g["matrix"], w["matrix"])


def test_kalman_filter_from_ss_devices():
    mats = [torch.tensor(M) for M in (A, B, C)]
    kf = llpt.kalman_filter_from_ss(*mats, 0, torch.tensor(R1),
                                    torch.tensor(R2), Ts=0.5)
    assert kf.Ts == 0.5 and kf.A is mats[0]
    kf = llpt.kalman_filter_from_ss(A, B, C, 0, R1, R2, device="cpu")
    assert kf.A.device.type == "cpu" and kf.A.dtype == torch.float64
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            llpt.kalman_filter_from_ss(A, B, C, 0, R1, R2)


def test_array_inputs_take_the_tensors_device_or_the_card():
    want = llpt.dare(*(torch.tensor(M) for M in (A, C, R1, R2)))
    got = llpt.dare(A, C, torch.tensor(R1), R2)
    assert got.device.type == "cpu" and got.dtype == torch.float64
    _close(got, want, "dare of arrays beside a CPU tensor")
    kt = _pair("benchmark")[1]
    lin = llpt.linearize(kt, np.zeros(2), np.zeros(1))
    assert all(M is None or M.device.type == "cpu" for M in lin)
    if not torch.cuda.is_available():
        for call in (lambda: llpt.dare(A, C, R1, R2),
                     lambda: llpt.dlyap(A, R1),
                     lambda: llpt.obsv(A, C)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()
