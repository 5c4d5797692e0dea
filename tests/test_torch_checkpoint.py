"""PyTorch port: ``utils/checkpoint.py`` against the JAX package, both
ways, bitwise.

- A ``.npz`` written by the JAX package's ``save_pytree`` of a KF state
  and of a ``KalmanFilteringSolution`` loads into the port with
  ``load_pytree(like=...)``, every tensor equal bit for bit, on the
  device and in the dtype of ``like``; the port's files load into the
  JAX package.
- A particle filter's state saved after some steps, generator included,
  and resumed with ``resume_state``: the next steps give the cloud and
  the log-likelihoods of the uninterrupted run, bit for bit.
- ``use_orbax=True`` raises (orbax is a JAX library).
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

T = 40


def _pair():
    kj = llpf.KalmanFilter(*(jnp.asarray(M) for M in (A, B, C)), 0,
                           jnp.asarray(R1), jnp.asarray(R2))
    kt = convert.kalman_filter_from_numpy(A, B, C, 0, R1, R2, device="cpu")
    rng = np.random.default_rng(0)
    u, y = rng.normal(size=(T, 1)), rng.normal(size=(T, 2))
    sj = jax.jit(lambda u, y: llpf.forward_trajectory(kj, u, y))(
        jnp.asarray(u), jnp.asarray(y))
    st = llpt.forward_trajectory(kt, torch.tensor(u), torch.tensor(y))
    # a state with every entry distinct from the initial one
    xj = llpf.KFState(x=jnp.asarray(rng.normal(size=2)),
                      R=jnp.asarray(rng.normal(size=(2, 2))),
                      t=jnp.asarray(7))
    return xj, kt.init(), sj, st


def _equal_leaves(got, want):
    """Every tensor of the port's ``got`` bitwise equal to the matching
    JAX leaf of ``want``."""
    import dataclasses

    n = 0
    for f in dataclasses.fields(got):
        g, w = getattr(got, f.name), getattr(want, f.name, None)
        if isinstance(g, torch.Tensor):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=f.name)
            n += 1
    return n


def test_jax_files_load_into_the_port(tmp_path):
    xj, like_state, sj, like_sol = _pair()
    llpf.save_pytree(str(tmp_path / "state.npz"), xj)
    st = llpt.load_pytree(str(tmp_path / "state.npz"), like_state)
    assert _equal_leaves(st, xj) == 2 and st.t == 7 and type(st.t) is int
    llpf.save_pytree(str(tmp_path / "sol"), sj)
    sol = llpt.load_pytree(str(tmp_path / "sol"), like_sol)
    assert _equal_leaves(sol, sj) >= 10 and sol.route == like_sol.route
    # the dtype and device of ``like`` win
    like32 = like_state.replace(x=like_state.x.float(),
                                R=like_state.R.float())
    st32 = llpt.load_pytree(str(tmp_path / "state.npz"), like32)
    assert st32.x.dtype == torch.float32
    np.testing.assert_array_equal(st32.x.numpy(),
                                  np.asarray(xj.x).astype(np.float32))


def test_port_files_load_into_jax(tmp_path):
    xj, _, sj, st = _pair()
    kt_state = llpt.KFState(x=torch.tensor(np.asarray(xj.x)) + 1.0,
                            R=torch.tensor(np.asarray(xj.R)), t=3)
    llpt.save_pytree(str(tmp_path / "state.npz"), kt_state)
    back = llpf.load_pytree(str(tmp_path / "state.npz"), xj)
    np.testing.assert_array_equal(np.asarray(back.x), kt_state.x.numpy())
    np.testing.assert_array_equal(np.asarray(back.R), kt_state.R.numpy())
    assert int(back.t) == 3
    llpt.save_pytree(str(tmp_path / "sol.npz"), st)
    sol = llpf.load_pytree(str(tmp_path / "sol.npz"), sj)
    assert _equal_leaves(st, sol) >= 10


def test_resumed_pf_continues_its_stream(tmp_path):
    fs, gs = convert.linear_callbacks(A, B, C, dtype=torch.float64,
                                      device="cpu")
    pf = convert.particle_filter_from_numpy(
        500, fs, gs, R1, R2, R1, resample_threshold=0.5,
        dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(1)
    u = torch.tensor(rng.normal(size=(12, 1)))
    y = torch.tensor(rng.normal(size=(12, 2)))

    def run(st, ks):
        lls = []
        for k in ks:
            st, info = pf.update(st, u[k], y[k])
            lls.append(info.ll)
        return st, torch.stack(lls)

    st, _ = run(pf.init(torch.Generator().manual_seed(3)), range(6))
    llpt.save_pytree(str(tmp_path / "pf"), st)
    want, ll_want = run(st, range(6, 12))
    got = llpt.resume_state(pf, str(tmp_path / "pf"),
                            generator=torch.Generator())
    assert got.t == 6 and got.generator is not st.generator
    got, ll_got = run(got, range(6, 12))
    for k in ("x", "w", "we"):
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    assert torch.equal(ll_got, ll_want)


def test_orbax_is_refused(tmp_path):
    st = llpt.KFState(x=torch.zeros(2), R=torch.eye(2), t=0)
    with pytest.raises(NotImplementedError, match="JAX library"):
        llpt.save_pytree(str(tmp_path / "x"), st, use_orbax=True)
    with pytest.raises(NotImplementedError, match="JAX library"):
        llpt.load_pytree(str(tmp_path / "x"), st, use_orbax=True)
