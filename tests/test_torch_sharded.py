"""PyTorch port: the sharded execution layer (parallel/sharded.py) on
gloo ranks against the JAX package's ``shard_map`` verbs.

One spawn of four CPU ranks (tests/_torch_parity.py::start_sharded_ranks,
which imports no JAX) runs every case over the four ranks, and rank 0
runs the deterministic cases once more alone (world size 1).  The JAX
functions run here on meshes of 4 and 1 of the virtual CPU devices
(tests/conftest.py), on the same numpy inputs.

- Exact (float64, rtol 1e-10): the time-sharded KF and RTS smoother
  (constant and time-varying A), ``_correct_local``, and
  ``_resample_global`` / ``_resample_distributed`` with the JAX draw of
  the offset r, including weights skewed onto one shard, which force the
  ring fallback.
- Statistical: ``sharded_forward_trajectory`` and
  ``sharded_pf_loglik_fused`` (kernel A's segment mode, its plain twin
  here; the mean of 3 calls) within 1 % of the KF ll at N = 4096, the
  sharded APF within 3 % (it never scores y[0], as in the reference),
  and the sharded FFBS mean within 0.4 RTS deviations (RMS) of the RTS
  smoother, chip_smoke.py's FFBS bound.  Every log-likelihood comes back
  equal on all ranks.
- Placement: ``shard_bank`` over ``bank_mesh``, and a verb refusing data
  off the mesh's device.
- The member-sharded EnKF step (``sharded_enkf_update``) against the
  port's unsharded correct + predict on the same replayed draws
  (rtol 1e-10), over four ranks and one.

Run as a script, this file prints the 32- and 8-step segment readings
of the fused sharded PF at chip_smoke.py's size (:func:`_segment_readings`).

The cases are grouped into few test items: pytest-xdist's ``loadfile``
mode hands out files with more items first, and this one should not run
ahead of the suite's longest files.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P
from _torch_parity import A, B, C, R1, R2, start_sharded_ranks

import lowlevelparticlefilters_jl_tpu as llpf
from lowlevelparticlefilters_jl_tpu.filters.particle import (
    PFState as JState)
from lowlevelparticlefilters_jl_tpu.parallel import sharded as jsh

WORLD, T, NP = 4, 64, 256
EXACT = dict(rtol=1e-10, atol=1e-12)


def _inputs():
    rng = np.random.default_rng(11)
    scale = 1.0 + 0.01 * np.sin(np.arange(T))
    c = dict(A=A, A_t=scale[:, None, None] * A[None], B=B, C=C, R1=R1,
             R2=R2, m0=np.array([0.2, -0.1]), P0=0.5 * np.eye(2),
             u=np.full((T, 1), 0.3), N=4096, M=200, segment=4,
             threshold=0.1)
    # the data: a draw of the model itself, so the PF estimates are sharp
    x = rng.multivariate_normal(c["m0"], c["P0"])
    ys = []
    for t in range(T):
        ys.append(C @ x + rng.multivariate_normal(np.zeros(2), R2))
        x = A @ x + B @ c["u"][t] + rng.multivariate_normal(np.zeros(2), R1)
    c["y"] = np.array(ys)
    w = rng.normal(size=NP)
    c["correct"] = dict(x=rng.normal(size=(NP, 2)), w=w - np.log(
        np.exp(w).sum()), y=np.array([0.4, -0.2]))
    c["correct"]["we"] = np.exp(c["correct"]["w"])
    c["resample"] = {}
    for key, th, skew in (("th1", 1.0, False), ("th05", 0.5, False),
                          ("th02", 0.2, False), ("skew", 1.0, True)):
        if skew:   # all weight on the last shard's particles
            we = np.r_[np.full(NP - NP // WORLD, 1e-12),
                       np.full(NP // WORLD, 1.0)]
        else:
            we = np.exp(rng.normal(size=NP))
        we = we / we.sum()
        jkey = jax.random.PRNGKey(100 + len(c["resample"]))
        r = float(jax.random.uniform(jax.random.split(jkey)[1], (),
                                     jnp.float64))
        c["resample"][key] = dict(x=rng.normal(size=(NP, 2)), w=np.log(we),
                                  we=we, threshold=th, r=r, key=jkey)
    # the EnKF step: 64 members, their draws of the perturbed
    # observations (R2) and of the process noise (R1)
    NE = 64
    c["enkf"] = dict(
        A=A, B=B, C=C, R1=R1, R2=R2, P0=0.5 * np.eye(2), inflation=1.05,
        X=rng.normal(size=(NE, 2)), u=np.array([0.3]),
        y=np.array([0.4, -0.2]),
        eps=rng.multivariate_normal(np.zeros(2), R2, size=NE),
        w=rng.multivariate_normal(np.zeros(2), R1, size=NE))
    return c


@pytest.fixture(scope="module")
def case():
    return _inputs()


@pytest.fixture(scope="module")
def started(case, tmp_path_factory):
    ports = {k: {kk: vv for kk, vv in v.items() if kk != "key"}
             for k, v in case["resample"].items()}
    return start_sharded_ranks(WORLD, tmp_path_factory.mktemp("ranks"),
                               dict(case, resample=ports))


def _mesh(n, axis):
    return Mesh(np.array(jax.devices()[:n]), (axis,))


def _jax_kf(c, A_):
    return llpf.KalmanFilter(
        jnp.asarray(A_), jnp.asarray(c["B"]), jnp.asarray(c["C"]), 0,
        jnp.asarray(c["R1"]), jnp.asarray(c["R2"]),
        d0=llpf.MvNormal(jnp.asarray(c["m0"]), jnp.asarray(c["P0"])))


def _jax_pf(c, threshold):
    Aj, Bj, Cj = (jnp.asarray(c[k]) for k in ("A", "B", "C"))
    return llpf.ParticleFilter(
        N=NP, dynamics=lambda x, u, p, t: Aj @ x + Bj @ u,
        measurement=lambda x, u, p, t: Cj @ x,
        dynamics_density=jnp.asarray(c["R1"]),
        measurement_density=jnp.asarray(c["R2"]),
        initial_density=jnp.asarray(c["P0"]), resample_threshold=threshold)


def _jstate(d, key=None):
    return JState(x=jnp.asarray(d["x"]), w=jnp.asarray(d["w"]),
                  we=jnp.asarray(d["we"]), t=jnp.asarray(0, jnp.int32),
                  key=jax.random.PRNGKey(0) if key is None else key)


_SPEC = JState(x=P("p", None), w=P("p"), we=P("p"), t=P(), key=P())


@pytest.fixture(scope="module")
def want(case, started):
    """The JAX package's results, computed while the ranks run.  Each
    function runs under jit: the shard_map then compiles once, where
    eagerly it dispatches op by op."""
    out = {}
    u, y = jnp.asarray(case["u"]), jnp.asarray(case["y"])
    for world in (WORLD, 1):
        mesh = _mesh(world, "time")
        for which in ("const", "tv"):
            kf = _jax_kf(case, case["A"] if which == "const"
                         else case["A_t"])
            # the smoother returns the time-sharded filter's (xt, Rt, ll)
            # too, from the body time_sharded_parallel_kf runs
            out["smooth", which, world] = jax.jit(
                lambda u, y: jsh.time_sharded_parallel_smooth(
                    kf, u, y, mesh))(u, y)
        pmesh = _mesh(world, "p")
        pf = _jax_pf(case, 1.0)
        uc, yc = jnp.asarray(case["u"][0]), jnp.asarray(case["correct"]["y"])

        @jax.jit
        @partial(jax.shard_map, mesh=pmesh, in_specs=(_SPEC,),
                 out_specs=(P("p"), P("p"), P()), check_vma=False)
        def correct(st):
            st, info = jsh._correct_local(pf, st, uc, yc, None, 0.0, "p")
            return st.w, st.we, info.ll

        out["correct", world] = correct(_jstate(case["correct"]))
        for key, d in case["resample"].items():
            pf = _jax_pf(case, d["threshold"])
            for fn in ("_resample_global", "_resample_distributed"):
                go = jax.jit(partial(
                    jax.shard_map, mesh=pmesh, in_specs=(_SPEC,),
                    out_specs=(P("p", None), P("p"), P("p")),
                    check_vma=False)(
                        lambda st, fn=fn, pf=pf: getattr(jsh, fn)(
                            st, pf, "p")[:3]))
                out[fn, key, world] = go(_jstate(d, d["key"]))
    kf = _jax_kf(case, case["A"])
    ss = jax.jit(lambda u, y: llpf.smooth(kf, u, y))(u, y)
    out["kf"] = (float(ss.sol.ll), np.asarray(ss.xT), np.asarray(
        jnp.diagonal(ss.RT, axis1=-2, axis2=-1)))
    return out


@pytest.fixture(scope="module")
def ranks(started, want):
    return started()


def _cat(ranks, world, key, i=None):
    """The blocks of ``key`` (item ``i``) of every rank, in rank order."""
    got = [ranks[r][world][key] for r in range(world)]
    if i is not None:
        got = [g[i] for g in got]
    return np.concatenate(got)


@pytest.mark.parametrize("world", [WORLD, 1])
def test_time_sharded_kf_and_smooth_match_jax(want, ranks, world):
    """Constant and time-varying A."""
    for which in ("const", "tv"):
        ws = want["smooth", which, world]
        for key, w_ in ((f"kf_{which}", ws[2:]), (f"smooth_{which}", ws)):
            for i, w in enumerate(w_):
                if np.ndim(w) == 0:   # the ll, replicated
                    for r in range(world):
                        np.testing.assert_allclose(
                            ranks[r][world][key][i], float(w), **EXACT,
                            err_msg=key)
                else:
                    np.testing.assert_allclose(
                        _cat(ranks, world, key, i), np.asarray(w), **EXACT,
                        err_msg=f"{key}[{i}]")


@pytest.mark.parametrize("world", [WORLD, 1])
def test_correct_local_matches_jax(want, ranks, world):
    w_ = want["correct", world]
    for i in range(2):
        np.testing.assert_allclose(_cat(ranks, world, "correct", i),
                                   np.asarray(w_[i]), **EXACT)
    for r in range(world):
        np.testing.assert_allclose(ranks[r][world]["correct"][2],
                                   float(w_[2]), **EXACT)


@pytest.mark.parametrize("world", [WORLD, 1])
def test_resamplers_match_jax(want, ranks, world):
    """Both resamplers on each weight profile; the skewed weights take the
    ring fallback on every rank, the others the neighbour exchange, and
    at world size 1 neither (the global path)."""
    for fn in ("_resample_global", "_resample_distributed"):
        for key in ("th1", "th05", "th02", "skew"):
            w_ = want[fn, key, world]
            for i in range(3):
                np.testing.assert_allclose(
                    _cat(ranks, world, f"{fn}_{key}", i), np.asarray(w_[i]),
                    **EXACT, err_msg=f"{fn} {key} [{i}]")
    for key in ("th1", "th05", "th02", "skew"):
        want_ring = int(key == "skew" and world > 1)
        assert {ranks[r][world][f"ring_{key}"] for r in range(world)} == {
            want_ring}, key


@pytest.mark.parametrize("world", [WORLD, 1])
def test_sharded_enkf_step_matches_unsharded(ranks, world):
    """``sharded_enkf_update``: the ranks' member blocks, in rank order,
    equal the unsharded correct + predict on the same draws, and the ll
    comes back equal on every rank and equal to the unsharded one
    (rtol 1e-10: the moments are summed in another order)."""
    Xs, ll, X1, ll1, t = ranks[0][world]["enkf"]
    np.testing.assert_allclose(_cat(ranks, world, "enkf", 0), X1, **EXACT)
    for r in range(world):
        got = ranks[r][world]["enkf"]
        assert got[1] == ll and got[4] == t == 1, r
    np.testing.assert_allclose(ll, ll1, **EXACT)


def test_sharded_pf_lls_near_kf(want, ranks):
    """Each ll equal on every rank and within its bound of the KF's."""
    ll_kf = want["kf"][0]
    for key, bound in (("ll_forward", 0.01), ("ll_fused", 0.01),
                       ("ll_apf", 0.03), ("ll_ffbs", 0.01)):
        lls = [ranks[r][WORLD][key] for r in range(WORLD)]
        assert all(v == lls[0] for v in lls), (key, lls)
        ll = float(np.mean(lls[0]))
        assert abs(ll - ll_kf) < bound * abs(ll_kf), (key, ll, ll_kf)


def test_bank_blocks_and_device_check(ranks):
    """``shard_bank`` gives each rank its rows of the bank in rank order;
    a verb refuses data on a device other than the mesh's."""
    np.testing.assert_array_equal(_cat(ranks, WORLD, "bank_block"),
                                  np.arange(2.0 * WORLD)[:, None])
    for r in range(WORLD):
        assert ranks[r][WORLD]["off_mesh"] == (
            "a tensor on meta; the mesh is on cpu"), r


def test_sharded_ffbs_mean_near_rts(want, ranks):
    _, xT, varT = want["kf"]
    means = [ranks[r][WORLD]["xb_mean"] for r in range(WORLD)]
    assert all(np.array_equal(m, means[0]) for m in means)  # replicated
    assert means[0].shape == xT.shape
    rms = float(np.sqrt(np.mean((means[0] - xT) ** 2 / varT)))
    assert rms < 0.4, rms


def _segment_readings():
    """The ll of ``sharded_pf_loglik_fused`` relative to the KF's at
    N = 1e5, T = 1000, threshold 0.1 on chip_smoke.py phase 18's model and
    data, with 32- and 8-step segments: the JAX package's function (keys 0
    and 1, one CPU device) and the port's (its plain twin on a gloo world
    of size 1, generators seeded 0 and 1), both in float32.  Run from the
    repository's root:

        PYTHONPATH=. python tests/test_torch_sharded.py
    """
    import torch

    import lowlevelparticlefilters_jl_tpu_torch as llpt
    from lowlevelparticlefilters_jl_tpu_torch import convert
    from lowlevelparticlefilters_jl_tpu_torch.parallel import sharded as tsh

    N, T, thresh = 100_000, 1000, 0.1
    kf = convert.kalman_filter_from_numpy(A, B, C, 0, R1, R2, device="cpu")
    u = torch.full((T, 1), 0.3, dtype=torch.float64)
    _, u, y = llpt.simulate(kf, u, torch.Generator().manual_seed(1))
    ll_kf = float(llpt.loglik(kf, u, y))
    f, g = convert.linear_callbacks(A, B, C, device="cpu")
    pf = convert.particle_filter_from_numpy(N, f, g, R1, R2, R1,
                                            resample_threshold=thresh,
                                            device="cpu")
    Aj, Bj, Cj = (jnp.asarray(m, jnp.float32) for m in (A, B, C))
    jpf = llpf.ParticleFilter(
        N=N, dynamics=lambda x, u, p, t: Aj @ x + Bj @ u,
        measurement=lambda x, u, p, t: Cj @ x,
        dynamics_density=jnp.asarray(R1, jnp.float32),
        measurement_density=jnp.asarray(R2, jnp.float32),
        initial_density=jnp.asarray(R1, jnp.float32),
        resample_threshold=thresh)
    uj, yj = (jnp.asarray(a.numpy(), jnp.float32) for a in (u, y))
    mesh, tmesh = _mesh(1, "particles"), tsh.particle_mesh(device="cpu")
    print(f"KF ll {ll_kf}; (ll - ll_KF) / |ll_KF| at N={N}, T={T}")
    for segment in (32, 8):
        for seed in (0, 1):
            ll_j = float(jsh.sharded_pf_loglik_fused(
                jpf, uj, yj, jax.random.PRNGKey(seed), mesh,
                segment=segment))
            ll_t = float(tsh.sharded_pf_loglik_fused(
                pf, u.float(), y.float(),
                torch.Generator().manual_seed(seed), tmesh, segment=segment))
            print(f"segment {segment} seed {seed}: JAX package "
                  f"{(ll_j - ll_kf) / abs(ll_kf):+.4%}, port "
                  f"{(ll_t - ll_kf) / abs(ll_kf):+.4%}", flush=True)


if __name__ == "__main__":
    _segment_readings()
