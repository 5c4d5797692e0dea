"""A single-card compile-and-run check and a multi-rank dry run
(counterpart of ``__graft_entry__.py``).

- :func:`entry` returns ``(fn, args)``: one bootstrap-PF ``update`` at
  N = 8192 on the benchmark's 2-state model (the reference's
  docs/src/benchmark.md), on the card unless ``device`` says otherwise.
- :func:`dryrun_multichip` runs one step of this domain's "training
  step" on the ranks of a ``torch.distributed`` group: the gradient of
  ``−mean kf_bank_loglik`` over a bank of trajectories split over the
  mesh's ``bank`` axis, an SGD step, and the sharded verbs on its
  ``particles`` axis and on the whole group.  It spawns nothing: every
  rank of the group calls it (gloo ranks with CPU tensors, or one card on
  NCCL, where a world of size 1 is started if none exists).

The mesh is laid out as the JAX package's: (n/2, 2) ranks for an even
n, else (1, n); rank r has bank index r // n_particles and particle
index r % n_particles.  The sizes (``DRYRUN_SIZES``) do not depend on the
layout, so every layout computes the same loss and parameters, and the
same deterministic log-likelihoods, as one rank.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from .kernels._lib import default_device

#: the benchmark's 2-state rotation system
SYSTEM = dict(A=[[0.97043, -0.097368], [0.097368, 0.970437]],
              B=[[0.1], [0.0]], C=[[1.0, 0.0], [0.0, 1.0]],
              R1=[[0.01, 0.0], [0.0, 0.01]], R2=[[0.1, 0.0], [0.0, 0.1]])

#: the dry run's sizes: the JAX package's at 8 devices (a (4, 2) mesh),
#: fixed for every layout; each divides by the axis it is split over
DRYRUN_SIZES = dict(n_traj=8, T=8, N_pf=128, N_enkf=64, T_ffbs=6, M_ffbs=8,
                    n_chains=8, R_chains=4, T_fused=16, N_fused=1024,
                    segment=8, lr=1e-3)


def _system(dtype, device):
    return {k: torch.tensor(v, dtype=dtype, device=device)
            for k, v in SYSTEM.items()}


def _linear_pf(N, s, threshold=1.0):
    from .filters.particle import ParticleFilter
    from .ops.mvnormal import MvNormal

    A, B, C = s["A"], s["B"], s["C"]
    zero = torch.zeros_like(s["A"][0])
    return ParticleFilter(
        N=N, dynamics=lambda x, u, p, t: A @ x + B @ u,
        measurement=lambda x, u, p, t: C @ x,
        dynamics_density=MvNormal(zero, s["R1"]),
        measurement_density=MvNormal(zero, s["R2"]),
        initial_density=MvNormal(zero, s["R1"]),
        resample_threshold=threshold)


def entry(device=None):
    """``(fn, args)``: ``fn(state, u, y) -> (state, ll)`` is one
    bootstrap-PF ``update`` at N = 8192 on the benchmark's model;
    ``args`` holds the initial state (a generator seeded 0) and one
    input and measurement, on ``device`` (the card unless named)."""
    device, dtype = default_device(device), torch.float32
    pf = _linear_pf(8192, _system(dtype, device))
    state0 = pf.init(torch.Generator(device=device).manual_seed(0))
    u0 = torch.tensor([0.3], dtype=dtype, device=device)
    y0 = torch.tensor([0.1, -0.2], dtype=dtype, device=device)

    def fn(state, u, y):
        state, info = pf.update(state, u, y)
        return state, info.ll

    return fn, (state0, u0, y0)


def mesh_layout(n: int) -> tuple:
    """``(n_bank, n_particles)`` of n ranks: (n/2, 2) for an even n > 1,
    else (1, n)."""
    return (n // 2, 2) if n % 2 == 0 and n > 1 else (1, n)


def _subgroups(mesh, layout):
    """The ``bank`` and ``particles`` sub-meshes of this rank: the ranks
    that share its particle index, and those that share its bank index.
    Every rank of the group creates every subgroup, in one order; with
    one rank both are the group itself."""
    from .parallel.sharded import particle_mesh

    if mesh.size == 1:
        return mesh, mesh
    n_bank, n_part = layout
    grid = [[mesh.ranks[i * n_part + j] for j in range(n_part)]
            for i in range(n_bank)]
    mine = {}
    for axis, groups in (("bank", [[row[j] for row in grid]
                                   for j in range(n_part)]),
                         ("particles", grid)):
        for ranks in groups:
            g = dist.new_group(ranks)
            if dist.get_rank() in ranks:
                mine[axis] = g
    return (particle_mesh(mine["bank"], device=mesh.device),
            particle_mesh(mine["particles"], device=mesh.device))


def bank_data(n_traj: int, T: int, seed: int = 0):
    """The bank's data, ``(us, ys)`` [n_traj, T, ·] in float64 on the CPU:
    u = 0 and trajectory b simulated from the benchmark's model with a
    generator seeded ``seed + b``."""
    from .filters.kalman import KalmanFilter
    from .trajectory import simulate

    s = _system(torch.float64, "cpu")
    kf = KalmanFilter(s["A"], s["B"], s["C"], 0, s["R1"], s["R2"])
    us = torch.zeros((n_traj, T, 1), dtype=torch.float64)
    ys = torch.stack([simulate(kf, us[b], torch.Generator().manual_seed(
        seed + b))[2] for b in range(n_traj)])
    return us, ys


def bank_loss(params: dict, us, ys):
    """``−Σ kf_bank_loglik`` of the trajectories given, for the KF whose
    dynamics matrix is ``params["A"]`` and whose R1 is
    ``diag(exp(params["logdiagR1"]))`` (d0 = N(0, 0.01 I)); the mean over
    the bank divides this sum by the bank's size."""
    from .filters.bank import kf_bank_loglik
    from .filters.kalman import KalmanFilter
    from .ops.mvnormal import MvNormal

    A = params["A"]
    s = _system(A.dtype, A.device)
    kf = KalmanFilter(A, s["B"], s["C"], 0,
                      torch.diag(torch.exp(params["logdiagR1"])), s["R2"],
                      d0=MvNormal(torch.zeros(2, dtype=A.dtype,
                                              device=A.device),
                                  0.01 * torch.eye(2, dtype=A.dtype,
                                                   device=A.device)))
    return -kf_bank_loglik(kf, us, ys).sum()


def dryrun_multichip(group=None, device=None, *,
                     dtype=torch.float32) -> dict:
    """One step of the sharded training step on the ranks of ``group``
    (default: the world, started with one rank on ``device`` where none
    exists; ``device`` defaults to the card).  Every rank of the group
    calls it.  Returns, on every rank, a dict of this rank's results:
    ``loss``, ``grads`` and the updated ``params`` (replicated), the
    log-likelihoods (replicated) of the sharded PF, EnKF and APF steps,
    the temporal-parallel KF, the sharded FFBS, the fused sharded PF and
    the time-sharded KF and smoother, the mesh PMMH ``chains`` (the
    global array), this rank's blocks ``xb`` (FFBS) and ``xT`` (the
    time-sharded smoother), the bank's data ``us``/``ys`` (float64, the
    CPU) and the ``layout``."""
    from .filters.enkf import EnsembleKalmanFilter
    from .filters.kalman import KalmanFilter
    from .filters.particle import AuxiliaryParticleFilter
    from .ops.mvnormal import MvNormal
    from .paramest import metropolis_parallel
    from .parallel import sharded as sh
    from .parallel.temporal import parallel_forward_trajectory

    z = DRYRUN_SIZES
    mesh = sh.particle_mesh(group, device=device)
    dev = mesh.device
    layout = mesh_layout(mesh.size)
    bmesh, pmesh = _subgroups(mesh, layout)
    s = _system(dtype, dev)

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    # ---- the bank axis: gradient step of −mean ll over the trajectories
    us64, ys64 = bank_data(z["n_traj"], z["T"])
    k = z["n_traj"] // bmesh.size
    if k * bmesh.size != z["n_traj"]:
        raise ValueError(f"a bank of {z['n_traj']} is not divisible by "
                         f"{bmesh.size} ranks")
    blk = slice(bmesh.rank * k, (bmesh.rank + 1) * k)
    us, ys = (a[blk].to(dtype=dtype, device=dev) for a in (us64, ys64))
    params = {"A": s["A"].clone().requires_grad_(),
              "logdiagR1": torch.log(torch.diagonal(s["R1"])).clone()
              .requires_grad_()}
    local = bank_loss(params, us, ys) / z["n_traj"]
    g = torch.autograd.grad(local, list(params.values()))
    loss = sh._psum(local.detach(), bmesh)
    grads = {name: sh._psum(gi, bmesh) for name, gi in zip(params, g)}
    params = {name: (p - z["lr"] * grads[name]).detach()
              for name, p in params.items()}

    # ---- the particles axis: PF, EnKF, APF steps; the parallel KF -------
    u0 = torch.zeros(1, dtype=dtype, device=dev)
    y0 = torch.tensor([0.1, -0.2], dtype=dtype, device=dev)
    pf = _linear_pf(z["N_pf"], s)
    _, info, _ = sh.sharded_update(pf, sh.shard_pf_state(pf.init(gen(1)),
                                                         pmesh),
                                   u0, y0, mesh=pmesh)
    zero = torch.zeros(2, dtype=dtype, device=dev)
    A, Bm, C = s["A"], s["B"], s["C"]
    enkf = EnsembleKalmanFilter(
        dynamics=lambda x, u, p, t: A @ x + Bm @ u,
        measurement=lambda x, u, p, t: C @ x, R1=s["R1"], R2=s["R2"],
        d0=MvNormal(zero, torch.eye(2, dtype=dtype, device=dev)),
        N=z["N_enkf"], nu=1)
    _, enkf_ll = sh.sharded_enkf_update(
        enkf, sh.shard_enkf_state(enkf.init(gen(2)), pmesh), u0, y0,
        mesh=pmesh)
    kf = KalmanFilter(A, Bm, C, 0, s["R1"], s["R2"])
    pkf_ll = parallel_forward_trajectory(
        kf, us64[0].to(dtype=dtype, device=dev),
        ys64[0].to(dtype=dtype, device=dev)).ll
    apf = AuxiliaryParticleFilter(pf=pf)
    _, apf_info = sh.sharded_apf_update(
        apf, sh.shard_pf_state(pf.init(gen(3)), pmesh), u0, y0, y1=y0,
        mesh=pmesh)
    T6 = z["T_ffbs"]
    us6 = torch.zeros((T6, 1), dtype=dtype, device=dev)
    ys6 = torch.full((T6, 2), 0.1, dtype=dtype, device=dev)
    xb, ffbs_ll = sh.sharded_ffbs_smooth(pf, us6, ys6, z["M_ffbs"], gen(4),
                                         pmesh)

    # ---- mesh PMMH over the bank axis -------------------------------------
    chains = metropolis_parallel(
        1, lambda th: -0.5 * torch.sum((th - 1.0) ** 2), z["R_chains"],
        torch.full((2,), 0.5, dtype=dtype, device=dev), generator=gen(5),
        n_chains=z["n_chains"], mesh=bmesh)

    # ---- the whole group: fused sharded PF, time-sharded KF and RTS -------
    T8 = z["T_fused"]
    us8, ys8 = (a[0].to(dtype=dtype, device=dev)
                for a in bank_data(1, T8, seed=6))
    # kernel A admits float32 filters and data only
    pf8 = _linear_pf(z["N_fused"], _system(torch.float32, dev),
                     threshold=0.1)
    fused_ll = sh.sharded_pf_loglik_fused(pf8, us8.float(), ys8.float(),
                                          gen(7), mesh, segment=z["segment"])
    *_, ts_ll = sh.time_sharded_parallel_kf(kf, us8, ys8, mesh)
    xT, _, _, _, ts_smooth_ll = sh.time_sharded_parallel_smooth(kf, us8,
                                                                ys8, mesh)
    out = dict(loss=loss, grads=grads, params=params, pf_ll=info.ll,
               enkf_ll=enkf_ll, pkf_ll=pkf_ll, apf_ll=apf_info.ll,
               ffbs_ll=ffbs_ll, xb=xb, chains=chains, fused_ll=fused_ll,
               ts_ll=ts_ll, ts_smooth_ll=ts_smooth_ll, xT=xT, us=us64,
               ys=ys64, layout=layout)
    for name in ("loss", "pf_ll", "enkf_ll", "pkf_ll", "apf_ll", "ffbs_ll",
                 "fused_ll", "ts_ll", "ts_smooth_ll"):
        v = float(out[name])
        if not math.isfinite(v):
            raise RuntimeError(f"dryrun_multichip: {name} is not finite "
                               f"({v})")
    for name in ("xb", "chains", "xT"):
        if not bool(torch.isfinite(out[name]).all()):
            raise RuntimeError(f"dryrun_multichip: {name} is not finite")
    return out
