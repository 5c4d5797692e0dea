"""PyTorch port: kernel A (kernels/pf_scan.py) against the JAX whole-scan
PF kernel.

The JAX kernel runs in interpret mode with zero process noise and
resampling offset r = 0.5 (``pf_loglik_fused(..., force_kernel=True)``,
as tests/test_pf_scan.py runs it); the port's plain twin runs with
``noise="none"``, which is the same deterministic recursion.  Both get
the same initial cloud x0.  f32, N = 512."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import lattice_case

import lowlevelparticlefilters_jl_tpu as llpf
from lowlevelparticlefilters_jl_tpu.ops.pallas.pf_scan import (
    pf_loglik_fused as jax_pf_loglik_fused)
from lowlevelparticlefilters_jl_tpu_torch import convert
from lowlevelparticlefilters_jl_tpu_torch.kernels import pf_scan

A = np.array([[0.97, -0.1], [0.1, 0.97]], np.float32)
B = np.array([[0.1], [0.0]], np.float32)
C = np.eye(2, dtype=np.float32)
R1z = 1e-12 * np.eye(2, dtype=np.float32)
R2 = 0.1 * np.eye(2, dtype=np.float32)
N = 512


def _pair(th, state_free_meas=False):
    Aj, Bj, Cj = (jnp.asarray(M, jnp.float32) for M in (A, B, C))
    Cm = 0.0 * C if state_free_meas else C
    Cmj = jnp.asarray(Cm, jnp.float32)
    pj = llpf.ParticleFilter(
        N=N, dynamics=lambda x, u, p, t: Aj @ x + Bj @ u,
        measurement=lambda x, u, p, t: Cmj @ x,
        dynamics_density=jnp.asarray(R1z), measurement_density=jnp.asarray(R2),
        initial_density=llpf.MvNormal(jnp.zeros(2, jnp.float32),
                                      jnp.eye(2, dtype=jnp.float32)),
        resample_threshold=th)
    f, g = convert.linear_callbacks(A, B, Cm, device="cpu")
    pt = convert.particle_filter_from_numpy(N, f, g, R1z, R2, np.eye(2),
                                            resample_threshold=th,
                                            device="cpu")
    return pj, pt


def _data(T, seed=1):
    rng = np.random.default_rng(seed)
    x0 = rng.normal(size=(N, 2)).astype(np.float32)
    us = 0.3 * np.ones((T, 1), np.float32)
    ys = rng.normal(size=(T, 2)).astype(np.float32)
    return x0, us, ys


def _run_both(th, T, state_free_meas=False):
    pj, pt = _pair(th, state_free_meas)
    x0, us, ys = _data(T)
    llj, nj = jax_pf_loglik_fused(pj, jnp.asarray(us), jnp.asarray(ys), 0,
                                  x0=jnp.asarray(x0), force_kernel=True)
    llt, nt = pf_scan.pf_loglik_fused(pt, torch.tensor(us), torch.tensor(ys),
                                      0, x0=torch.tensor(x0), noise="none")
    return float(llj), float(nj), float(llt), float(nt)


def test_no_resample_crosses_a_block():
    """Threshold 0 never fires; T = 140 crosses the JAX kernel's 128-step
    input block."""
    llj, nj, llt, nt = _run_both(0.0, 140)
    np.testing.assert_allclose(llt, llj, rtol=1e-5)
    assert nt == nj == 0.0


def test_always_resample_state_free_measurement():
    """Equal weights make the systematic selection the identity for any r,
    so every step resamples and the clouds stay equal."""
    llj, nj, llt, nt = _run_both(1.0, 12, state_free_meas=True)
    np.testing.assert_allclose(llt, llj, rtol=1e-5)
    assert nt == nj == 12.0


def test_neff_trigger_and_quantized_slots():
    """Threshold 0.5 fires on some steps through the int-quantized slot
    boundaries.  A one-quantum difference in the f32 weights' sum order
    can move one boundary, and with zero noise the cloud is impoverished,
    so ll is held to 1e-3 and the resample count exactly."""
    llj, nj, llt, nt = _run_both(0.5, 30)
    assert 1 <= nj <= 29
    assert nt == nj
    np.testing.assert_allclose(llt, llj, rtol=1e-3)


def test_affine_probe_admission():
    _, pt = _pair(0.1)
    u = torch.full((5, 1), 0.3)
    tv = torch.arange(5.0)
    coef = pf_scan.affine_coefficients(pt, u, tv)
    assert coef.shape == (5, 2 * 2 + 2 + 2 * 2 + 2)
    torch.testing.assert_close(coef[0, :4].reshape(2, 2), torch.tensor(A))
    torch.testing.assert_close(coef[:, 4:6], (torch.tensor(B) @ u.T).T)
    torch.testing.assert_close(coef[0, 6:10].reshape(2, 2), torch.tensor(C))


@pytest.mark.parametrize("which,fn", [
    ("dynamics", lambda x, u, p, t: torch.sin(x)),
    ("measurement", lambda x, u, p, t: x * x),
    ("dynamics", lambda x, u, p, t: torch.clamp(x, -3.0, 3.0)),
    ("measurement", lambda x, u, p, t: torch.relu(x)),
    ("dynamics", lambda x, u, p, t: torch.where(t == 2.0, x * x, x)),
], ids=["sin", "square", "clamp", "relu", "nonaffine_mid_step"])
def test_affine_probe_rejects(which, fn):
    """Non-affine callbacks are not admitted, piecewise-linear ones and
    ones non-affine only at a middle step included: the probes sit four
    standard deviations of d0 out, at every step."""
    _, pt = _pair(0.1)
    u = torch.full((5, 1), 0.3)
    tv = torch.arange(5.0)
    assert pf_scan.affine_coefficients(pt.replace(**{which: fn}), u,
                                       tv) is None


def test_lattice_case_resamples_and_sees_a_one_slot_fault(monkeypatch):
    """The exact resampling case that holds kernel A to its twin on the
    card (tests/test_torch_cuda.py): it fires on some steps only, and a
    gather that puts one wrong particle in one slot changes the result."""
    pf, u, y, x0 = lattice_case(4096, 60, "cpu")
    args = pf_scan.scan_inputs(pf, u, y)
    kw = dict(N=4096, thresh=float(pf.resample_threshold), seed=0,
              noise="none", x0=x0)
    ll, n = pf_scan.pf_loglik_scan_plain(*args, **kw)
    assert float(n) == 7.0 and np.isfinite(float(ll))
    right = pf_scan.slot_sources

    def one_slot_off(K, M=None):
        j = right(K, M).clone()
        j[2048] = min(int(j[2048]) + 1, K.shape[-1] - 1)
        return j

    monkeypatch.setattr(pf_scan, "slot_sources", one_slot_off)
    llf, nf = pf_scan.pf_loglik_scan_plain(*args, **kw)
    assert (float(llf), float(nf)) != (float(ll), float(n))


def test_plain_twin_philox_is_reproducible():
    _, pt = _pair(0.1)
    pt = pt.replace(dynamics_density=pt.dynamics_density.replace(
        cov=0.01 * torch.eye(2)))
    _, us, ys = _data(20, 3)
    a = pf_scan.pf_loglik_fused(pt, torch.tensor(us), torch.tensor(ys), 42)
    b = pf_scan.pf_loglik_fused(pt, torch.tensor(us), torch.tensor(ys), 42)
    c = pf_scan.pf_loglik_fused(pt, torch.tensor(us), torch.tensor(ys), 43)
    assert float(a[0]) == float(b[0]) and float(a[0]) != float(c[0])
    assert np.isfinite(float(a[0]))


def test_static_walk_routes_a_clamped_callback_sequential(monkeypatch):
    """``A x + B u`` clamped to ±5 is affine wherever the probes look (four
    deviations of d0 out), so only the static walk of the lowered
    callbacks (``ukf_scan.callbacks_affine``) keeps it from kernel A:
    under ``method="fused"`` it routes sequential, while the unclamped
    filter takes kernel A's twin.  The walk runs once per filter."""
    import lowlevelparticlefilters_jl_tpu_torch as llpt
    from lowlevelparticlefilters_jl_tpu_torch.kernels import ukf_scan

    _, pt = _pair(0.1)
    At, Bt = torch.tensor(A), torch.tensor(B)
    clamped = pt.replace(dynamics=lambda x, u, p, t: torch.clamp(
        At @ x + Bt @ u, -5.0, 5.0))
    _, us, ys = _data(6)
    u, y = torch.tensor(us), torch.tensor(ys)
    assert pf_scan.affine_coefficients(clamped, u, torch.arange(6.0)) \
        is not None
    walks = []
    walk = ukf_scan.callback_affine_in_x
    monkeypatch.setattr(ukf_scan, "callback_affine_in_x",
                        lambda *a: walks.append(1) or walk(*a))
    g = torch.Generator().manual_seed(0)
    clamped.loglik(u, y, generator=g, method="fused")
    assert llpt.last_route("loglik") == "sequential"
    for _ in range(2):
        pt.loglik(u, y, generator=g, method="fused")
        assert llpt.last_route("loglik") == "fused_scan_plain"
    assert len(walks) == 1 + 2  # clamped: dynamics only; pt: both, once
