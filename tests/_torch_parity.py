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
