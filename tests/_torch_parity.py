"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py);
``chip_smoke.py`` takes its lattice case from here too.

Inputs are made with numpy from a seed and handed to both packages; JAX
runs on the CPU with x64 (tests/conftest.py), so every JAX array is built
with an explicit dtype.  Tests of the CUDA kernels take the
``cuda_device`` fixture and carry the ``cuda`` marker: they skip where
``torch.cuda.is_available()`` is false, decided when the test runs.

The rank bodies of the sharded tests (:func:`run_sharded_ranks`) live
here because a spawned rank imports this module, which imports no JAX.
"""
import datetime
import os
import pickle

import numpy as np
import pytest
import torch

# the benchmark's 2-state model (bench.py:389-393)
A = np.array([[0.97043, -0.097368], [0.097368, 0.970437]])
B = np.array([[0.1], [0.0]])
C = np.eye(2)
R1 = 0.01 * np.eye(2)
R2 = 0.1 * np.eye(2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def lattice_case(N, T, device="cpu", seed=0):
    """A no-noise filter whose resampling is exact in f32 in any sum order.

    States are multiples of 8 in 8 coordinates (four with 2 levels, four
    with 8), the dynamics is the identity, and step t measures the one
    coordinate that the one-hot ``u_t`` picks, with variance 1/(2π).  A
    particle that matches ``y_t`` (the track of particle 0) scores 0 on top
    of its weight, one that does not about -201, whose exp is 0 in f32.
    So every weight is 0 or 1 and every sum is an exact integer.  Each
    coordinate is revealed once and then all revealed ones are measured
    again, so a particle a gather put in the wrong slot dies there.  The
    threshold 1 - 0.5/N fires on every step where a particle dies and on
    no other.  Step 5 is missing (NaN).  Returns ``(pf, u, y, x0)``.
    """
    from lowlevelparticlefilters_jl_tpu_torch import convert

    rng = np.random.default_rng(seed)
    x0 = np.stack([8.0 * rng.integers(0, L, N)
                   for L in (2, 2, 2, 2, 8, 8, 8, 8)], 1)
    sched = []
    for i in range(8):
        sched += [i] + list(range(i + 1))
    sched = (sched + list(range(8)) * T)[:T]
    u = np.eye(8)[sched]
    y = x0[0, sched][:, None].copy()
    y[5] = np.nan
    pf = convert.particle_filter_from_numpy(
        N, lambda x, u, p, t: x, lambda x, u, p, t: (u @ x).reshape(1),
        np.eye(8), [[1 / (2 * np.pi)]], np.eye(8),
        resample_threshold=1 - 0.5 / N, device=device)
    return pf, *(torch.tensor(a, dtype=torch.float32, device=device)
                 for a in (u, y, x0))


# ---- the beetle IMM (examples/example_beetle_imm.py) ----------------------

BEETLE_P = [[0.995, 0.005], [0.0, 1.0]]


def beetle_dynamics(mode: float, xp):
    """The example's augmented-dynamics UKF form ``f(x, u, p, t, w)`` in
    ``xp`` (``jax.numpy`` or ``torch``); ``p`` is the mode gain."""
    def dyn(x, u, p, t, w):
        v_n = xp.abs(0.999 * x[2] + w[2])
        th_n = x[3] + w[3] * (1 + mode * p) / (1 + v_n)
        return xp.stack([x[0] + w[0] + v_n * xp.cos(x[3]),
                         x[1] + w[1] + v_n * xp.sin(x[3]), v_n, th_n])

    return dyn


def beetle_track(T: int, seed=0, t_switch=None):
    """A track of the example's generative model drawn with numpy (the
    searching mode's heading noise amplified from ``t_switch``, T/2 by
    default): ``(xs [T, 4], ys [T, 2])``."""
    rng = np.random.default_rng(seed)
    t_switch = T // 2 if t_switch is None else t_switch
    x, xs = np.array([0.0, 0.0, 0.5, 0.3]), []
    for t in range(T):
        w = rng.normal(size=4) * np.array([0.03, 0.03, 0.05, 0.1])
        w[3] *= 1 + (t >= t_switch) * 8.0
        v = abs(0.999 * x[2] + w[2])
        x = np.array([x[0] + w[0] + v * np.cos(x[3]),
                      x[1] + w[1] + v * np.sin(x[3]), v,
                      x[3] + w[3] / (1 + v)])
        xs.append(x)
    xs = np.array(xs)
    return xs, xs[:, :2] + 0.1 * rng.normal(size=(T, 2))


def beetle_params():
    """The example's hand-tuned parameter vector: log10 of R1's diagonal,
    log10 of R2's scale, log10 of (mode gain - 2)."""
    return np.r_[np.log10([1e-2, 1e-2, 0.05 ** 2, 0.1 ** 2]), 0.0,
                 np.log10(8.0 - 2.0)]


def beetle_imm(theta, y0, *, dtype=torch.float64, device="cpu"):
    """The port's IMM of two augmented-dynamics UKFs built from the
    parameter vector ``theta`` (a tensor, so autograd reaches it), as the
    example's ``build_imm`` builds the JAX one; d0 is centred on the
    first measurement ``y0``."""
    import lowlevelparticlefilters_jl_tpu_torch as llpt

    R1 = torch.diag(10.0 ** theta[:4])
    R2 = 10.0 ** theta[4] * 0.01 * torch.eye(2, dtype=dtype, device=device)
    gain = 2.0 + 10.0 ** theta[5]
    d0 = llpt.MvNormal(torch.cat([torch.as_tensor(y0, dtype=dtype,
                                                  device=device),
                                  torch.tensor([0.5, 0.3], dtype=dtype,
                                               device=device)]),
                       torch.diag(torch.tensor([3.0, 3.0, 2.0, 2.0],
                                               dtype=dtype, device=device)))
    modes = tuple(llpt.make_ukf(beetle_dynamics(m, torch),
                                lambda x, u, p, t: x[:2], R1, R2, d0=d0,
                                nu=0, ny=2, nw=4, augmented_dynamics=True,
                                p=gain)
                  for m in (0.0, 1.0))
    return llpt.IMM(modes, torch.tensor(BEETLE_P, dtype=dtype,
                                        device=device),
                    torch.tensor([1.0, 0.0], dtype=dtype, device=device))


# ---- the RBPF's degenerate models (tests/test_rbpf.py) --------------------

RB_A = np.array([[1.0, 0.1], [0.0, 1.0]])
RB_B = np.array([[0.0], [1.0]])
RB_C = np.array([[1.0, 0.0]])
RB_R2 = 10.0 * np.eye(1)


def rb_linear_kf(dtype=torch.float64, device="cpu"):
    """The double integrator of tests/test_rbpf.py as the exact KF (R1 the
    double-integrator covariance at 0.1 plus 1e-6 I, R2 = 10, d0 =
    N(0, 2 I)): the reference of every RBPF model below."""
    from lowlevelparticlefilters_jl_tpu_torch import convert
    from lowlevelparticlefilters_jl_tpu_torch.ops.discretize import (
        double_integrator_covariance)

    R1 = np.asarray(double_integrator_covariance(0.1)) + 1e-6 * np.eye(2)
    return convert.kalman_filter_from_numpy(RB_A, RB_B, RB_C, 0, R1, RB_R2,
                                            None, 2.0 * np.eye(2),
                                            dtype=dtype, device=device)


def rb_model(which: str, N: int, threshold: float, *, dtype=torch.float64,
             device="cpu"):
    """The port's RBPF of tests/test_rbpf.py's degenerate models on the
    double integrator: ``"linear"`` (a fake 1-state nonlinear part with
    g = 0, everything in the KF, single Riccati), ``"nonlinear"`` (a fake
    linear state, C = 0, everything in the particles) and ``"augmented"``
    (the same, the noise passed into the dynamics)."""
    from lowlevelparticlefilters_jl_tpu_torch import convert

    kf = rb_linear_kf(dtype, device)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa
    A_, B_, C_ = t(RB_A), t(RB_B), t(RB_C)
    if which == "linear":
        return convert.rbpf_from_numpy(
            N, kf, lambda xn, u, p, t: xn,
            lambda xn, u, p, t: torch.zeros_like(xn), RB_R2,
            1e-12 * np.eye(1), 1e-12 * np.eye(1), nu=1,
            resample_threshold=threshold, dtype=dtype, device=device)
    kf2 = convert.kalman_filter_from_numpy(
        np.zeros((1, 1)), np.zeros((1, 1)), np.zeros((1, 1)), 0, np.eye(1),
        RB_R2, None, np.zeros((1, 1)), dtype=dtype, device=device)
    R1 = np.asarray(kf.R1.cpu())
    if which == "nonlinear":
        dyn = lambda xn, u, p, t: A_ @ xn + B_ @ u  # noqa: E731
    else:
        dyn = lambda xn, u, p, t, w: A_ @ xn + B_ @ u + w  # noqa: E731
    return convert.rbpf_from_numpy(
        N, kf2, dyn, lambda xn, u, p, t: C_ @ xn, RB_R2, R1, 2.0 * np.eye(2),
        nu=1, resample_threshold=threshold,
        augmented_dynamics=which == "augmented", dtype=dtype, device=device)


# A third-order integrator split for the coupled (An) RBPF: the position
# p is the particles' state, the velocity and its drive [v, b] the KF's;
# y = [p, v] + e, so the ll depends on every column of the resampled rows
RBC_A = np.array([[1.0, 0.1, 0.0], [0.0, 1.0, 0.1], [0.0, 0.0, 0.9]])
RBC_B = np.array([[0.0], [0.1], [0.0]])
RBC_C = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
RBC_R1 = np.diag([0.01, 0.01, 0.01])
RBC_R2 = 0.5 * np.eye(2)


def rb_coupled(N: int, threshold: float, single_riccati: bool = True, *,
               dtype=torch.float64, device="cpu"):
    """``(rbpf, kf)``: the coupled RBPF of the third-order integrator
    above (``An`` = the position's row on [v, b]; one Riccati recursion,
    or one a particle, rows ``[p, v, b]`` or ``[p, v, b, vec(R)]``) and
    the exact KF of the whole model, its reference (d0 = N(0, I))."""
    from lowlevelparticlefilters_jl_tpu_torch import convert

    kw = dict(dtype=dtype, device=device)
    kf = convert.kalman_filter_from_numpy(RBC_A, RBC_B, RBC_C, 0, RBC_R1,
                                          RBC_R2, None, np.eye(3), **kw)
    kfl = convert.kalman_filter_from_numpy(
        RBC_A[1:, 1:], RBC_B[1:], RBC_C[:, 1:], 0, RBC_R1[1:, 1:], RBC_R2,
        None, np.eye(2), **kw)
    return convert.rbpf_from_numpy(
        N, kfl, lambda xn, u, p, t: xn,
        lambda xn, u, p, t: torch.cat([xn, torch.zeros_like(xn)]), RBC_R2,
        RBC_R1[:1, :1], np.eye(1), An=RBC_A[:1, 1:], nu=1,
        resample_threshold=threshold, single_riccati=single_riccati,
        **kw), kf


# ---- the linear scalar DAE (tests/test_daeukf.py) ------------------------

DAE_C1, DAE_DT = 0.7, 0.1


def dae_callbacks(xp):
    """``ẋ = −x + z + w, 0 = x + z − c, y = z + v`` (Euler steps of 0.1)
    in ``xp``: ``(dynamics, measurement, residual, get_x_z, build_xz)``."""
    def get_x_z(xz):
        return xz[:1], xz[1:]

    def build_xz(x, z):
        return xp.concatenate([x, z])

    def dynamics(xz, u, p, t):
        x, z = get_x_z(xz)
        new_x = x + DAE_DT * (-x + z)
        return build_xz(new_x, DAE_C1 - new_x)

    return (dynamics, lambda xz, u, p, t: xz[1:],
            lambda x, z, u, p, t: x + z - DAE_C1, get_x_z, build_xz)


def dae_filter(Q, R, P0, x0, *, dtype=torch.float64, device="cpu", **kw):
    """The port's DAE-UKF of the scalar DAE, its descriptor on the
    manifold at ``x0``."""
    from lowlevelparticlefilters_jl_tpu_torch import convert

    return convert.daeukf_from_numpy(
        *dae_callbacks(torch), [[Q]], [[R]], [x0], [[P0]],
        [x0, DAE_C1 - x0], Ts=DAE_DT, nu=1, dtype=dtype, device=device, **kw)


def dae_kf(Q, R, P0, x0, ys):
    """The analytic scalar KF of the reduced system (z = c − x) over the
    measurements ``ys`` (predict, then correct): ``(xs, Ps)``."""
    alpha, beta, H = 1 - 2 * DAE_DT, DAE_DT, -1.0
    x, P, xs, Ps = x0, P0, [], []
    for yk in ys:
        x = alpha * x + beta * DAE_C1
        P = alpha ** 2 * P + Q
        K = P * H / (H ** 2 * P + R)
        x = x + K * (yk - (H * x + DAE_C1))
        P = (1 - K * H) * P
        xs.append(x)
        Ps.append(P)
    return np.array(xs), np.array(Ps)


def np_of(a) -> np.ndarray:
    """A JAX array or torch tensor as a float64 numpy array."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
    return np.asarray(a, dtype=np.float64)


# ---- the sharded verbs on gloo ranks (tests/test_torch_sharded.py) --------


def start_sharded_ranks(world: int, tmp_path, cases: dict):
    """Spawn ``world`` gloo ranks on the CPU that run
    :func:`_sharded_cases` on ``cases`` (numpy inputs) over the whole
    world, and rank 0 once more alone on a group of its own.  Returns at
    once a function that waits for the ranks and returns ``{rank: {group
    size: results}}``, so the caller can work meanwhile."""
    import torch.multiprocessing as mp

    store, out = str(tmp_path / "store"), str(tmp_path / "out")
    ctx = mp.start_processes(_sharded_rank, args=(world, store, out, cases),
                             nprocs=world, join=False, start_method="spawn")

    def results():
        while not ctx.join():
            pass
        got = {}
        for r in range(world):
            with open(f"{out}.{r}", "rb") as f:
                got[r] = pickle.load(f)
        return got

    return results


def _sharded_rank(rank, world, store, out, cases):
    import torch.distributed as dist

    from lowlevelparticlefilters_jl_tpu_torch.parallel import sharded as sh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        alone, _ = dist.new_subgroups(group_size=1)
        res = {world: _sharded_cases(sh.particle_mesh(device="cpu"), cases,
                                     stats=True)}
        if rank == 0:
            res[1] = _sharded_cases(sh.particle_mesh(alone, device="cpu"),
                                    cases, stats=False)
        with open(f"{out}.{rank}.tmp", "wb") as f:
            pickle.dump(res, f)
        os.replace(f"{out}.{rank}.tmp", f"{out}.{rank}")
    finally:
        dist.destroy_process_group()


def _np(t):
    return t.detach().cpu().numpy()


def _enkf_case(mesh, e: dict) -> list:
    """``sharded_enkf_update`` on this rank's block of the members against
    the unsharded ``correct`` + ``predict`` on the same draws: the global
    perturbed observations and process noise of ``e`` are replayed through
    ``filters/enkf.py::_sample``, each rank taking its block.  Returns
    ``[X block, ll, unsharded X, unsharded ll, t]``."""
    from lowlevelparticlefilters_jl_tpu_torch import convert
    from lowlevelparticlefilters_jl_tpu_torch.filters import enkf as fe
    from lowlevelparticlefilters_jl_tpu_torch.parallel import sharded as sh

    N = e["X"].shape[0]
    fs, gs = convert.linear_callbacks(e["A"], e["B"], e["C"],
                                      dtype=torch.float64, device="cpu")
    enkf = convert.enkf_from_numpy(N, fs, gs, e["R1"], e["R2"], None,
                                   e["P0"], inflation=e["inflation"],
                                   device="cpu")
    draws = []

    def replay(d, generator, n):
        lo = 0 if n == N else mesh.rank * n
        return torch.tensor(draws.pop(0)[lo:lo + n])

    real, fe._sample = fe._sample, replay
    try:
        u, y = torch.tensor(e["u"]), torch.tensor(e["y"])
        st = fe.EnKFState(X=torch.tensor(e["X"]), t=0,
                          generator=torch.Generator().manual_seed(0))
        draws[:] = [e["eps"], e["w"]]
        cs, info = enkf.correct(st, u, y)
        ps = enkf.predict(cs, u)
        draws[:] = [e["eps"], e["w"]]
        ss, ll = sh.sharded_enkf_update(enkf, sh.shard_enkf_state(st, mesh),
                                        u, y, mesh=mesh)
    finally:
        fe._sample = real
    return [_np(ss.X), float(ll), _np(ps.X), float(info.ll), ss.t]


def _sharded_cases(mesh, c: dict, stats: bool) -> dict:
    """The port's sharded verbs on ``mesh`` with the inputs of ``c`` (see
    tests/test_torch_sharded.py); every result as numpy, blocks local."""
    import lowlevelparticlefilters_jl_tpu_torch as llpt
    from lowlevelparticlefilters_jl_tpu_torch import convert
    from lowlevelparticlefilters_jl_tpu_torch.filters.particle import PFState
    from lowlevelparticlefilters_jl_tpu_torch.parallel import sharded as sh

    out = {}
    u, y = torch.tensor(c["u"]), torch.tensor(c["y"])
    for name, A_ in (("const", c["A"]), ("tv", c["A_t"])):
        kf = convert.kalman_filter_from_numpy(
            A_, c["B"], c["C"], 0, c["R1"], c["R2"], d0_mean=c["m0"],
            d0_cov=c["P0"], device="cpu")
        out[f"kf_{name}"] = [_np(v) for v in
                             sh.time_sharded_parallel_kf(kf, u, y, mesh)]
        out[f"smooth_{name}"] = [_np(v) for v in
                                 sh.time_sharded_parallel_smooth(kf, u, y,
                                                                 mesh)]

    def pf_of(threshold, N, dtype=torch.float64):
        fs, gs = convert.linear_callbacks(c["A"], c["B"], c["C"],
                                          dtype=dtype, device="cpu")
        return convert.particle_filter_from_numpy(
            N, fs, gs, c["R1"], c["R2"], c["P0"], d0_mean=c["m0"],
            resample_threshold=threshold, dtype=dtype, device="cpu")

    def local(st):
        return sh.shard_pf_state(PFState(
            x=torch.tensor(st["x"]), w=torch.tensor(st["w"]),
            we=torch.tensor(st["we"]), t=0), mesh)

    st = local(c["correct"])
    cs, info = sh._correct_local(pf_of(1.0, st.x.shape[0]), st,
                                 torch.tensor(c["u"][0]),
                                 torch.tensor(c["correct"]["y"]), None, 0.0,
                                 mesh)
    out["correct"] = [_np(cs.w), _np(cs.we), _np(info.ll)]

    rings = []
    ring = sh._ring_exchange

    def counted(*a):
        rings.append(1)
        return ring(*a)

    sh._ring_exchange = counted
    try:
        for key, case in c["resample"].items():
            st = local(case)
            pf = pf_of(case["threshold"], case["x"].shape[0])
            r = torch.tensor(case["r"], dtype=torch.float64)
            n0 = len(rings)
            for fn in ("_resample_global", "_resample_distributed"):
                out[f"{fn}_{key}"] = [_np(v) for v in
                                      getattr(sh, fn)(st, pf, mesh, r)]
            out[f"ring_{key}"] = len(rings) - n0
    finally:
        sh._ring_exchange = ring
    out["enkf"] = _enkf_case(mesh, c["enkf"])
    if not stats:
        return out

    # placement: a bank's block of each rank, and data off the mesh refused
    from lowlevelparticlefilters_jl_tpu_torch.parallel import bank as pb

    bank = {"y": torch.arange(2.0 * mesh.size).reshape(-1, 1)}
    out["bank_block"] = _np(pb.shard_bank(bank, pb.bank_mesh(
        device="cpu"))["y"])
    try:
        sh.time_sharded_parallel_kf(kf, u, y.to("meta"), mesh)
        out["off_mesh"] = "accepted"
    except ValueError as e:
        out["off_mesh"] = str(e)

    # statistical cases: the linear model's KF ll is the reference
    T = c["u"].shape[0]
    ut, yt = u, y
    gen = lambda s: torch.Generator().manual_seed(s)  # noqa: E731
    pf = pf_of(0.5, c["N"])
    *_, out["ll_forward"] = sh.sharded_forward_trajectory(pf, ut, yt,
                                                          gen(1), mesh)
    pf32 = pf_of(c["threshold"], c["N"], torch.float32)
    out["ll_fused"] = [sh.sharded_pf_loglik_fused(
        pf32, ut.float(), yt.float(), gen(10 + i), mesh,
        segment=c["segment"]) for i in range(3)]
    apf = llpt.AuxiliaryParticleFilter(pf=pf)
    st = sh.shard_pf_state(pf.init(gen(2)), mesh)
    ll = 0.0
    for k in range(T):
        st, info = sh.sharded_apf_update(
            apf, st, ut[k], yt[k], y1=yt[k + 1] if k + 1 < T else None,
            mesh=mesh)
        ll = ll + info.ll
    out["ll_apf"] = ll
    xb, out["ll_ffbs"] = sh.sharded_ffbs_smooth(pf, ut, yt, c["M"], gen(3),
                                                mesh)
    out["xb_mean"] = _np(xb.mean(1))
    for k in ("ll_forward", "ll_apf", "ll_ffbs"):
        out[k] = float(out[k])
    out["ll_fused"] = [float(v) for v in out["ll_fused"]]
    return out
