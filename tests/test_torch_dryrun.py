"""PyTorch port: ``dryrun.py`` (the counterpart of ``__graft_entry__.py``)
on the CPU.

- ``entry``: one bootstrap-PF update at N = 8192; its log-likelihood of
  the first measurement is the Monte Carlo estimate of the exact
  ``log N(y0; 0, C R1 Cᵀ + R2)`` (the cloud drawn from N(0, R1)), within
  the 5 % its N allows; the JAX package's ``entry`` estimates the same
  number.
- ``mesh_layout``: the JAX dry run's (bank, particles) layout.
- The entry points that make tensors from nothing raise without a card
  unless the CPU is named.
- ``bank_loss``: −Σ of the members' own ``loglik`` (rtol 1e-10), with a
  finite gradient.

The multi-rank dry run is a case of the sharded spawn
(tests/test_torch_sharded.py), which also holds its world-1 loss to JAX's.
"""
import jax
import numpy as np
import pytest
import torch
from scipy import stats

import __graft_entry__ as graft
from lowlevelparticlefilters_jl_tpu_torch import dryrun


def test_entry_update_estimates_the_exact_ll():
    fn, (state, u, y) = dryrun.entry(device="cpu")
    assert state.x.shape == (8192, 2) and state.x.dtype == torch.float32
    state1, ll = fn(state, u, y)
    s = dryrun.SYSTEM
    cov = np.array(s["C"]) @ np.array(s["R1"]) @ np.array(s["C"]).T \
        + np.array(s["R2"])
    exact = stats.multivariate_normal(np.zeros(2), cov).logpdf(
        y.double().numpy())
    assert state1.x.shape == (8192, 2) and state1.t == 1
    assert abs(float(ll) - exact) < 0.05 * abs(exact)
    jfn, jargs = graft.entry()
    _, jll = jax.jit(jfn)(*jargs)
    assert abs(float(jll) - exact) < 0.05 * abs(exact)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_mesh_layout_is_jax_dry_runs(n):
    want = (n // 2, 2) if n % 2 == 0 and n > 1 else (1, n)
    assert dryrun.mesh_layout(n) == want


def test_entry_points_need_a_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.dryrun_multichip()


def test_bank_loss_is_the_members_lls():
    """``bank_loss`` (through ``kf_bank_loglik``) is
    −Σ of each trajectory's own ``loglik``, and differentiable."""
    import lowlevelparticlefilters_jl_tpu_torch as llpt
    from lowlevelparticlefilters_jl_tpu_torch.ops.mvnormal import MvNormal

    z = dryrun.DRYRUN_SIZES
    us, ys = dryrun.bank_data(z["n_traj"], z["T"])
    s = {k: torch.tensor(v, dtype=torch.float64)
         for k, v in dryrun.SYSTEM.items()}
    params = {"A": s["A"].clone().requires_grad_(),
              "logdiagR1": torch.log(torch.diagonal(s["R1"]))
              .requires_grad_()}
    loss = dryrun.bank_loss(params, us, ys)
    kf = llpt.KalmanFilter(s["A"], s["B"], s["C"], 0, s["R1"], s["R2"],
                           d0=MvNormal(torch.zeros(2, dtype=torch.float64),
                                       0.01 * torch.eye(2,
                                                        dtype=torch.float64)))
    want = -sum(float(llpt.loglik(kf, us[b], ys[b]))
                for b in range(z["n_traj"]))
    np.testing.assert_allclose(float(loss.detach()), want, rtol=1e-10)
    grads = torch.autograd.grad(loss, list(params.values()))
    assert all(bool(torch.isfinite(g).all()) and bool(g.abs().sum() > 0)
               for g in grads)
