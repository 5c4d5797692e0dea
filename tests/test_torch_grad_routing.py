"""PyTorch port: routing keeps tensors that autograd records off the
forward-only CUDA kernels (routing._needs_grad).

Each case admits one kernel gate as it would on a card (the gate's
device test patched to pass) and replaces the kernel's wrapper with a
stub that fails when reached.  With a grad-requiring system matrix A the
verb must take the sequential route or the kernel's plain twin, and give
a finite gradient.  Without the gate the stub is reached.
"""
import numpy as np
import pytest
import torch
from _torch_parity import A, B, C, R1, R2

import lowlevelparticlefilters_jl_tpu_torch as llpt
from lowlevelparticlefilters_jl_tpu_torch import convert, routing
from lowlevelparticlefilters_jl_tpu_torch.kernels import (
    assoc_scan, bank_scan, ffbs, noise, pf_scan, resample_v2, ukf_scan)
from lowlevelparticlefilters_jl_tpu_torch.ops import resample as trs

T = 40
F32 = dict(dtype=torch.float32, device="cpu")


def _guard(monkeypatch, mod, name):
    """Replace ``mod.name`` by what its wrapper does on a card with a
    tensor that autograd records: fail.  Other calls go through."""
    orig = getattr(mod, name)

    def wrapper(*args, **kw):
        if torch.is_grad_enabled() and any(
                t.requires_grad
                for t in routing._tensor_leaves((args, list(kw.values())))):
            raise AssertionError(f"{name} was reached with grad")
        return orig(*args, **kw)

    monkeypatch.setattr(mod, name, wrapper)


@pytest.fixture
def data():
    g = torch.Generator().manual_seed(3)
    u = torch.full((T, 1), 0.3, **F32)
    y = 0.3 * torch.randn(T, 2, generator=g, **F32)
    return u, y


def _A():
    return torch.tensor(A, requires_grad=True, **F32)


def _kf(At):
    return convert.kalman_filter_from_numpy(A, B, C, 0, R1, R2,
                                            dtype=torch.float32,
                                            device="cpu").replace(A=At)


def _pf(At, **kw):
    Bt, Ct = (torch.tensor(M, **F32) for M in (B, C))
    return convert.particle_filter_from_numpy(
        64, lambda x, u, p, t: At @ x + Bt @ u, lambda x, u, p, t: Ct @ x,
        R1, R2, R1, dtype=torch.float32, device="cpu", **kw)


def _on_card(monkeypatch):
    """The routing predicates answer as they do for CUDA tensors."""
    monkeypatch.setattr(routing, "_want_fused",
                        lambda method, y: method in ("auto", "fused"))
    monkeypatch.setattr(routing, "_want_parallel",
                        lambda method, y, T: method in ("auto", "parallel"))
    monkeypatch.setattr(assoc_scan, "scan_supported", lambda nx, like: True)


def case_K_auto(monkeypatch, u, y, At):
    _on_card(monkeypatch)
    _guard(monkeypatch, assoc_scan, "plane_scan")
    return llpt.loglik(_kf(At), u, y), "loglik", "sequential"


def case_K_parallel(monkeypatch, u, y, At):
    _on_card(monkeypatch)
    _guard(monkeypatch, assoc_scan, "plane_scan")
    sol = llpt.forward_trajectory(_kf(At), u, y, method="parallel")
    assert sol.route == "temporal_parallel_plain"
    return sol.ll, "forward_trajectory", "temporal_parallel_plain"


def case_K_smooth(monkeypatch, u, y, At):
    _on_card(monkeypatch)
    _guard(monkeypatch, assoc_scan, "plane_scan")
    sm = llpt.smooth(_kf(At), u, y)
    return sm.xT.sum(), "smooth", "sequential"


def case_H_fused(monkeypatch, u, y, At):
    _on_card(monkeypatch)
    for name in ("akf_scan", "ekf_scan", "ukf_scan"):
        _guard(monkeypatch, ukf_scan, name)
    return llpt.loglik(_kf(At), u, y, method="fused"), "loglik", \
        "sequential"


def case_A_fused(monkeypatch, u, y, At):
    _guard(monkeypatch, pf_scan, "pf_scan")
    ll = _pf(At).loglik(u, y, generator=torch.Generator().manual_seed(0),
                        method="fused")
    return ll, "loglik", "sequential"


def case_BDE(monkeypatch, u, y, At, exact):
    _guard(monkeypatch, noise, "add_gaussian_noise")
    _guard(monkeypatch, trs, "systematic_gather")
    _guard(monkeypatch, resample_v2, "systematic_resample")
    _guard(monkeypatch, resample_v2, "systematic_slots")
    pf = _pf(At, resample_threshold=1.0, noise_backend="kernel",
             exact_resample=exact)
    sol = pf.forward_trajectory(u, y,
                                generator=torch.Generator().manual_seed(0))
    return sol.ll, "forward_trajectory", "sequential"


def case_F(monkeypatch, u, y, At):
    _on_card(monkeypatch)
    monkeypatch.setattr(bank_scan, "bank_kernel_profitable",
                        lambda *a: True)
    _guard(monkeypatch, bank_scan, "bank_loglik_kernel")
    ll = llpt.kf_bank_loglik(_kf(At), u, torch.stack([y, -y]))
    return ll.sum(), "kf_bank_loglik", "bank_plane"


def case_J(monkeypatch, u, y, At):
    monkeypatch.setattr(ffbs, "ffbs_kernel_supported", lambda *a: True)
    _guard(monkeypatch, ffbs, "ffbs_backward")
    xb, ll = _pf(At).smooth(u, y, M=16,
                            generator=torch.Generator().manual_seed(0))
    return xb.sum() + ll, "smooth", "ffbs_plain"


# a gate's cases, one test item each gate (pytest-xdist's loadfile mode
# hands out files with more items first; this file should not run ahead
# of the suite's longest files)
GATES = {"K": (case_K_auto, case_K_parallel, case_K_smooth),
         "H": (case_H_fused,), "A": (case_A_fused,),
         "B_D": (lambda *a: case_BDE(*a, exact=False),),
         "E_D": (lambda *a: case_BDE(*a, exact=True),),
         "F": (case_F,), "J": (case_J,)}


@pytest.mark.parametrize("gate", sorted(GATES))
def test_grad_keeps_auto_routes_off_the_kernels(monkeypatch, data, gate):
    u, y = data
    for case in GATES[gate]:
        with monkeypatch.context() as mp:
            At = _A()
            out, verb, route = case(mp, u, y, At)
            assert llpt.last_route(verb) == route, (case, route)
            (g,) = torch.autograd.grad(out, At)
        assert g.shape == (2, 2) and bool(torch.isfinite(g).all())
        assert float(g.abs().sum()) > 0


def test_no_grad_mode_admits_the_kernels(monkeypatch, data):
    """Under ``torch.no_grad`` nothing is recorded: the gate admits, and
    only the data's device decides."""
    u, y = data
    _on_card(monkeypatch)
    seen = []
    monkeypatch.setattr(assoc_scan, "filter_scan_p",
                        lambda e: seen.append(1)
                        or assoc_scan.filter_scan_p_plain(e))
    with torch.no_grad():
        llpt.loglik(_kf(_A()), u, y)
    assert seen and llpt.last_route("loglik") == "cuda_temporal_parallel"
    assert routing._needs_grad(_A()) and not routing._needs_grad(
        torch.zeros(2), np.zeros(2))
