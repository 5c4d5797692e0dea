"""Particle- and time-sharded execution on ``torch.distributed``
(counterpart of ``parallel/sharded.py``).

The JAX package shards an axis over a ``jax.sharding.Mesh`` and writes
each verb's per-device body under ``shard_map``.  Here the mesh is a
``torch.distributed`` process group (:class:`Mesh`) and the program is
SPMD: every rank calls the verb; the per-rank bodies take and return the
rank's LOCAL blocks, and replicated results (a log-likelihood) come back
equal on every rank.  The collectives map one to one:

- ``all_gather`` → ``dist.all_gather`` (the list form, which gloo has),
- ``psum`` / ``pmax`` / ``pmin`` → ``dist.all_reduce`` (SUM / MAX / MIN),
- ``ppermute`` → ``dist.batch_isend_irecv``,
- ``axis_index`` / ``axis_size`` → the rank and size of the group.

One card is a world of size 1 on NCCL; several ranks of one host run on
gloo with CPU tensors.

Random draws.  Where the JAX package splits a key every shard holds (the
systematic-resampling offset r), every rank draws from its
``torch.Generator``, seeded alike on all ranks, so the draws agree; where
it folds the shard index into a key (the process noise, a segment's
seed), a rank draws from a generator seeded from a shared draw and its
rank.  The private resamplers take r pre-drawn, so that tests can feed
the JAX package's draw.  Decisions that the JAX package takes with
``lax.cond`` (the Neff trigger, the overflow fallback, the ring's early
exit) are taken on the host from values that are equal on every rank.

The verbs:

- particle-sharded bootstrap PF: :func:`shard_pf_state`,
  :func:`sharded_update`, :func:`sharded_forward_trajectory`; the
  auxiliary PF step :func:`sharded_apf_update`; the FFBS smoother
  :func:`sharded_ffbs_smooth`; and :func:`sharded_pf_loglik_fused`, whose
  every segment on every rank is one launch of kernel A's segment mode
  (kernels/pf_scan.py);
- time-sharded Kalman filter and RTS smoother:
  :func:`time_sharded_parallel_kf` and :func:`time_sharded_parallel_smooth`,
  whose local level is kernel K's whole-element mode
  (``kernels/assoc_scan.filter_scan_full``).

The sharded EnKF (``shard_enkf_state``, ``sharded_enkf_update``) waits for
the port of ``filters/enkf.py``.
"""
from __future__ import annotations

import math
import os
import tempfile
from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist

from ..filters.particle import PFInfo, PFState, _uniform_weights
from ..kernels._lib import default_device
from ..ops.linalg import chol_lower, rdiv_chol, symmetrize, tri_solve
from ..ops.logsumexp import effective_particles
from ..ops.matrices import FnMat
from ..ops.mvnormal import as_mvnormal, mvnormal_logpdf_cov
from ..ops.resample import _cumsum, _uniform
from ..routing import _needs_grad, seed_from_generator
from ..trajectory import _as_u_seq
from .temporal import (_filter_combine, _mv_t, _resolve_seq, _smooth_combine,
                       associative_scan)


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: the process group (the sharded axis; the JAX package's
    axis name has no role here), this process's rank in it, the group's
    size and the device its tensors live on."""

    group: Any
    rank: int
    size: int
    device: torch.device
    ranks: tuple  # the global rank of each group rank (for send/recv)


def _init_world(device: torch.device) -> None:
    """A world of size 1 on ``device``: NCCL on the card, gloo on the
    CPU, its store a file in a new temporary directory."""
    path = os.path.join(tempfile.mkdtemp(prefix="llpt_mesh_"), "store")
    store = dist.FileStore(path, 1)
    if device.type == "cuda":
        index = (device.index if device.index is not None
                 else torch.cuda.current_device())
        dist.init_process_group("nccl", store=store, rank=0, world_size=1,
                                device_id=torch.device("cuda", index))
    else:
        dist.init_process_group("gloo", store=store, rank=0, world_size=1)


def particle_mesh(group=None, device=None) -> Mesh:
    """The mesh of ``group`` (default: the world) on ``device`` (default:
    the card; pass ``device="cpu"`` for gloo ranks).  Where no process
    group exists yet, a world of size 1 is started on the device."""
    device = default_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if group is None and not dist.is_initialized():
        _init_world(device)
    g = dist.group.WORLD if group is None else group
    size = dist.get_world_size(g)
    ranks = tuple(range(size)) if g is dist.group.WORLD else tuple(
        dist.get_global_rank(g, i) for i in range(size))
    return Mesh(g, dist.get_rank(g), size, device, ranks)


def _on_mesh(mesh: Mesh, *tensors) -> None:
    """Raise unless every tensor lies on the mesh's device (an NCCL
    group's collectives take card tensors, gloo's CPU ones)."""
    for t in tensors:
        if t is not None and t.device != mesh.device:
            raise ValueError(f"a tensor on {t.device}; the mesh is on "
                             f"{mesh.device}")


def shard_pf_state(state: PFState, mesh: Mesh) -> PFState:
    """This rank's block of a global :class:`PFState` on the mesh's
    device: particles and weights sliced on their leading axis; ``t`` and
    the generator (which must be seeded alike on every rank) stay as they
    are."""
    N = state.x.shape[0]
    if N % mesh.size:
        raise ValueError(f"N={N} is not divisible by {mesh.size} ranks")
    M = N // mesh.size
    sl = slice(mesh.rank * M, (mesh.rank + 1) * M)
    return state.replace(**{k: getattr(state, k)[sl].to(mesh.device)
                            for k in ("x", "w", "we")})


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


def _reduce(x: torch.Tensor, mesh: Mesh, op) -> torch.Tensor:
    t = x.reshape(-1).clone()   # all_reduce is in place; a 0-d value as [1]
    dist.all_reduce(t, op=op, group=mesh.group)
    return t.reshape(x.shape)


def _psum(x, mesh):
    return _reduce(x, mesh, dist.ReduceOp.SUM)


def _pmax(x, mesh):
    return _reduce(x, mesh, dist.ReduceOp.MAX)


def _pmin(x, mesh):
    return _reduce(x, mesh, dist.ReduceOp.MIN)


def _all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``[size, *x.shape]``: every rank's ``x`` in rank order."""
    x = x.reshape(-1).contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    return torch.stack(parts)


def _ppermute(x: torch.Tensor, mesh: Mesh, perm) -> torch.Tensor:
    """``x`` sent along the (source, destination) rank pairs of ``perm``;
    a rank that no pair sends to receives zeros (``jax.lax.ppermute``)."""
    x = x.contiguous()
    out, ops = torch.zeros_like(x), []
    for src, dst in perm:
        if src == mesh.rank and dst == mesh.rank:
            out = x.clone()
        elif src == mesh.rank:
            ops.append(dist.P2POp(dist.isend, x, mesh.ranks[dst],
                                  mesh.group))
        elif dst == mesh.rank:
            ops.append(dist.P2POp(dist.irecv, out, mesh.ranks[src],
                                  mesh.group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


def _rank_generator(generator, mesh: Mesh, device) -> torch.Generator:
    """A generator for this rank alone, seeded from a draw of the shared
    ``generator`` and the rank (the JAX package's ``fold_in(key,
    shard)``)."""
    seed = seed_from_generator(generator)
    g = torch.Generator(device=device)
    return g.manual_seed((seed + 0x9E3779B97F4A7C15 * (mesh.rank + 1))
                         % (2**63 - 1))


# ---------------------------------------------------------------------------
# Particle-sharded bootstrap PF
# ---------------------------------------------------------------------------


def _normalized(w, mesh: Mesh):
    """(w − lse, exp(w − lse), lse) with the global logsumexp: a pmax
    offset and a psum normalizer."""
    offset = _pmax(w.max(), mesh)
    we = torch.exp(w - offset)
    s = _psum(we.sum(), mesh)
    return w - offset - torch.log(s), we / s, torch.log(s) + offset


def _correct_local(pf, state: PFState, u, y, p, t, mesh: Mesh):
    """Per-rank measurement update, normalized by the global logsumexp."""
    vm = torch.func.vmap
    if hasattr(pf, "measurement_likelihood"):  # AdvancedParticleFilter
        gl = pf.measurement_likelihood
        logp = vm(lambda xi: gl(xi, u, y, p, t))(state.x)
    else:
        g = pf.measurement
        yhat = vm(lambda xi: g(xi, u, p, t))(state.x)
        logp = pf.measurement_density.logpdf(y - yhat)
    missing = torch.isnan(y).any()
    w, we, ll = _normalized(torch.where(missing, state.w, state.w + logp),
                            mesh)
    ll = torch.where(missing, torch.zeros_like(ll), ll)
    return state.replace(w=w, we=we), PFInfo(ll=ll, e=torch.zeros_like(y))


def _resampled_weights(state: PFState, mesh: Mesh):
    """Uniform weights after a global resample: log(1/N) = log(1/M) −
    log(size) on each rank's M particles."""
    w0, we0 = _uniform_weights(state.x.shape[0], state.w)
    lS = torch.log(torch.tensor(float(mesh.size), dtype=state.w.dtype))
    return w0 - lS.item(), we0 / mesh.size


def _fires(pf, neff, N: int, force: bool) -> bool:
    return (force or pf.resample_threshold >= 1.0
            or bool(neff < pf.resample_threshold * N))


def _resample_global(state: PFState, pf, mesh: Mesh, r,
                     force_resample: bool = False):
    """Systematic resampling on the global weights, offset ``r`` (equal
    on every rank), with the weights and the particles gathered to every
    rank.  Returns this rank's ``(x, w, we)``; ``force_resample`` skips
    the Neff trigger (the APF's first stage)."""
    M = state.x.shape[0]
    N = M * mesh.size
    we_all = _all_gather(state.we, mesh).reshape(N)
    if not _fires(pf, effective_particles(we_all), N, force_resample):
        return state.x, state.w, state.we
    bins = _cumsum(we_all)
    i = mesh.rank * M + torch.arange(M, dtype=we_all.dtype,
                                     device=we_all.device)
    pts = (r + i) / N * bins[-1]
    j = torch.searchsorted(bins, pts, right=True).clamp_(0, N - 1)
    x_all = _all_gather(state.x, mesh).reshape(N, -1)
    return (x_all[j], *_resampled_weights(state, mesh))


def _resample_distributed(state: PFState, pf, mesh: Mesh, r,
                          force_resample: bool = False):
    """Systematic resampling with O(N/size) traffic (Murray, "Parallel
    resampling in the particle filter", arXiv:1301.4019), as the JAX
    package's ``_resample_distributed``: the ranks' weight sums are
    gathered (size numbers); each rank derives from its slot boundaries
    ``K_i = ceil(cdf_i N / total − r)`` the owner of every output slot in
    its ±1-rank window (a counting sort), and two neighbour exchanges
    deliver the segments.  If any rank's offspring leave its window, every
    rank learns it from a psum'd flag and the exchange rotates the
    particles around the ring instead, hop by hop, until every slot is
    served (at most size − 1 hops, O(N/size) memory).  Returns this rank's
    ``(x, w, we)``."""
    S = mesh.size
    if S == 1:
        return _resample_global(state, pf, mesh, r, force_resample)
    M = state.x.shape[0]
    N = M * S
    sums = _all_gather(state.we.sum(), mesh).reshape(S)
    total = sums.sum()
    O_s = (torch.cumsum(sums, 0) - sums)[mesh.rank]
    neff = total * total / _psum(torch.square(state.we).sum(), mesh)
    if not _fires(pf, neff, N, force_resample):
        return state.x, state.w, state.we
    K = torch.ceil((O_s + _cumsum(state.we)) * N / total - r).to(
        torch.int64).clamp_(0, N)
    K_base = int(torch.ceil(O_s * N / total - r).clamp(0, N))
    g0 = (mesh.rank - 1) * M
    overflow = K_base < g0 or int(K[-1]) > g0 + 3 * M
    overflow = int(_psum(torch.tensor(int(overflow), device=K.device),
                         mesh)) > 0
    x = (_ring_exchange(state.x, K, K_base, mesh) if overflow
         else _window_exchange(state.x, K, K_base, g0, mesh))
    return (x, *_resampled_weights(state, mesh))


def _owners(K, lo: int, W: int, M: int):
    """For the W output slots from ``lo`` on: the local particle that
    owns each, #{i : K_i <= slot}, by a counting sort."""
    hist = torch.bincount((K - lo).clamp(0, W), minlength=W + 1)
    return torch.cumsum(hist, 0)[:-1].clamp_(0, M - 1)


def _window_exchange(x, K, K_base: int, g0: int, mesh: Mesh):
    """The slots this rank's particles fill in the window [(s−1)M,
    (s+2)M): the left third goes to rank s−1, the right third to s+1,
    each with its validity as one more column."""
    M, S, N = x.shape[0], mesh.size, x.shape[0] * mesh.size
    W = 3 * M
    g = g0 + torch.arange(W, device=x.device)
    valid = (g >= K_base) & (g < K[-1]) & (g >= 0) & (g < N)
    seg = torch.where(valid[:, None], torch.cat(
        [x[_owners(K, g0, W, M)], valid[:, None].to(x.dtype)], 1), 0.0)
    left, mid, right = seg.split(M)
    from_right = _ppermute(left, mesh, [(i, (i - 1) % S) for i in range(S)])
    from_left = _ppermute(right, mesh, [(i, (i + 1) % S) for i in range(S)])
    out = torch.zeros_like(x)
    for part in (mid, from_right, from_left):
        out = out + torch.where(part[:, -1:] > 0, part[:, :-1], 0.0)
    return out


def _ring_exchange(x, K, K_base: int, mesh: Mesh):
    """The overflow fallback: each rank's particles and slot boundaries
    travel one rank along the ring a hop, and every rank takes the output
    slots of its own range that the visiting block owns; the loop ends
    when a psum says every slot of every rank is served."""
    M, S = x.shape[0], mesh.size
    s0 = mesh.rank * M
    g = s0 + torch.arange(M, device=x.device)
    ring = [(i, (i + 1) % S) for i in range(S)]
    out = torch.zeros_like(x)
    covered = torch.zeros(M, dtype=torch.bool, device=x.device)
    xq = x
    kq = torch.cat([K, K.new_tensor([K_base])])   # boundaries, then base
    for _ in range(S):
        valid = (g >= kq[-1]) & (g < kq[-2]) & ~covered
        out = out + torch.where(valid[:, None], xq[_owners(kq[:-1], s0, M, M)],
                                0.0)
        covered |= valid
        xq, kq = _ppermute(xq, mesh, ring), _ppermute(kq, mesh, ring)
        done = _psum(covered.all().to(torch.int64), mesh)
        if int(done) >= S:
            break
    return out


def _predict_local(pf, state: PFState, u, p, t, mesh: Mesh, r,
                   noise_generator, distributed_resample: bool = True):
    """Per-rank propagation after the global resample with offset ``r``;
    the process noise from this rank's ``noise_generator``."""
    resample = (_resample_distributed if distributed_resample
                else _resample_global)
    x, w, we = resample(state, pf, mesh, r)
    if hasattr(pf, "measurement_likelihood"):  # AdvancedParticleFilter
        xn = pf.propagate(x, u, p, t, noise_generator)
    else:
        xn = torch.func.vmap(lambda xi: pf.dynamics(xi, u, p, t))(x)
        if pf.dynamics_density is not None:
            xn = xn + pf.dynamics_density.sample(noise_generator,
                                                 (x.shape[0],))
    return PFState(x=xn, w=w, we=we, t=state.t + 1,
                   generator=state.generator)


def _draws(state: PFState, mesh: Mesh, like: torch.Tensor):
    """A step's shared resampling offset r and this rank's noise
    generator, both from the state's generator."""
    r = _uniform(state.generator, (), like)
    return r, _rank_generator(state.generator, mesh, like.device)


def sharded_update(pf, state: PFState, u, y, p=None, t=None,
                   mesh: Mesh = None):
    """One correct + predict step of a particle filter whose particles
    are sharded over ``mesh``: ``state`` is this rank's block
    (:func:`shard_pf_state`).  Returns ``(state, info, (x, w, we))``, the
    last the filtered (post-correct) block."""
    if mesh is None:
        raise ValueError("sharded_update needs a mesh")
    _on_mesh(mesh, state.x, y)
    p = pf.p if p is None else p
    tk = state.t * pf.Ts if t is None else t
    if u is None:
        u = state.x.new_zeros(0)
    st, info = _correct_local(pf, state, u, y, p, tk, mesh)
    r, noise = _draws(st, mesh, st.w)
    return (_predict_local(pf, st, u, p, tk, mesh, r, noise), info,
            (st.x, st.w, st.we))


def sharded_forward_trajectory(pf, u, y, generator, mesh: Mesh, p=None):
    """Batch filtering with the particles sharded over ``mesh``: the
    initial cloud is drawn from ``generator`` (seeded alike on every
    rank), each rank keeps its block and runs :func:`sharded_update` each
    step.  Returns ``(xs [T, N/size, nx], ws, wes, ll)``: this rank's
    filtered blocks and the replicated log-likelihood."""
    _on_mesh(mesh, y)
    T = y.shape[0]
    u_seq = _as_u_seq(u, T, y.dtype, y.device)
    state = shard_pf_state(pf.init(generator), mesh)
    lls, xs, ws, wes = [], [], [], []
    for k in range(T):
        state, info, (x, w, we) = sharded_update(pf, state, u_seq[k], y[k],
                                                 p=p, mesh=mesh)
        lls.append(info.ll)
        xs.append(x)
        ws.append(w)
        wes.append(we)
    return (torch.stack(xs), torch.stack(ws), torch.stack(wes),
            torch.stack(lls).sum())


def sharded_apf_update(apf, state: PFState, u, y, y1=None, p=None, t=None,
                       mesh: Mesh = None):
    """One auxiliary-PF step with the particles sharded over ``mesh``:
    the normalization-only correct, then with the next measurement ``y1``
    the first-stage weights λ at the noiselessly propagated particles,
    the unconditional distributed resample on the combined weights, and
    the unresampled λ as second-stage weights (the reference's
    filtering.jl:187-234).  ``y1=None`` (the last step) only corrects.
    Returns ``(state, info)``."""
    from ..filters.particle import AdvancedParticleFilter

    if mesh is None:
        raise ValueError("sharded_apf_update needs a mesh")
    _on_mesh(mesh, state.x, y)
    inner = apf.pf
    p = inner.p if p is None else p
    tk = state.t * inner.Ts if t is None else t
    if u is None:
        u = state.x.new_zeros(0)
    w, we, ll = _normalized(state.w, mesh)
    st = state.replace(w=w, we=we)
    info = PFInfo(ll=ll, e=torch.zeros_like(y))
    if y1 is None:
        return st, info
    vm = torch.func.vmap
    M = st.x.shape[0]
    N = M * mesh.size
    advanced = isinstance(inner, AdvancedParticleFilter)
    if advanced:
        xpred = vm(lambda xi: inner.dynamics(xi, u, p, tk, None))(st.x)
        lam = vm(lambda xi: inner.measurement_likelihood(
            xi, u, y1, p, tk))(xpred)
        x_first = st.x      # the advanced filter resamples the current cloud
    else:
        f, g = inner.dynamics, inner.measurement
        xpred = vm(lambda xi: f(xi, u, p, tk))(st.x)
        lam = inner.measurement_density.logpdf(
            y1 - vm(lambda xi: g(xi, u, p, tk))(xpred))
        x_first = xpred     # the plain one resamples the prediction
    wb = st.w + lam
    web = _normalized(wb, mesh)[1]
    r, noise = _draws(st, mesh, st.w)
    x, w0, we0 = _resample_distributed(st.replace(x=x_first, w=wb, we=web),
                                       inner, mesh, r, force_resample=True)
    if advanced:
        xn = inner.propagate(x, u, p, tk, noise)
        return PFState(x=xn, w=w0, we=we0, t=st.t + 1,
                       generator=st.generator), info
    if inner.dynamics_density is not None:
        x = x + inner.dynamics_density.sample(noise, (M,))
    # the unresampled λ stay on the weights (filtering.jl:210-212)
    w_new = lam - math.log(N)
    return PFState(x=x, w=w_new, we=_normalized(w_new, mesh)[1],
                   t=st.t + 1, generator=st.generator), info


def sharded_ffbs_smooth(pf, u, y, M: int, generator, mesh: Mesh, p=None):
    """FFBS with the forward cloud's particles sharded over ``mesh``:
    :func:`sharded_forward_trajectory`, then per step and trajectory a
    Gumbel-max champion of the backward weights ``wf + log N(xb | f(xf),
    R1)`` over this rank's particles; the global winner is the rank with
    the largest champion score (pmax, ties to the lowest rank by pmin),
    whose particle a psum delivers.  Gumbel-max decomposes over the
    ranks, so this is an exact draw from the whole categorical with
    [M]-sized collectives.  Returns ``(xb [T, M, nx], ll)``, replicated."""
    T = y.shape[0]
    u_seq = _as_u_seq(u, T, y.dtype, y.device)
    p = pf.p if p is None else p
    df = as_mvnormal(pf.dynamics_density)
    nx = df.mean.shape[-1]
    Linv = tri_solve(df.chol(), torch.eye(nx, dtype=y.dtype,
                                          device=y.device), lower=True)
    mu = df.mean
    xs, ws, _, ll = sharded_forward_trajectory(pf, u_seq, y, generator,
                                               mesh, p=p)
    gen = _rank_generator(generator, mesh, y.device)

    def select(score, cand):
        gmax = _pmax(score, mesh)
        top = score >= gmax
        winner = torch.where(top, mesh.rank, mesh.size)
        is_win = top & (winner == _pmin(winner, mesh))
        return _psum(torch.where(is_win[:, None], cand, 0.0), mesh)

    def draw(scores, xf):
        sc = scores + _gumbel(gen, (M, xf.shape[0]), xf)
        best, am = sc.max(1)
        return select(best, xf[am])

    f = pf.dynamics
    from ..smoothing import _gumbel

    xb = draw(ws[-1][None, :], xs[-1])
    out = [xb]
    for t in range(T - 2, -1, -1):
        xf = xs[t]
        xpred = torch.func.vmap(
            lambda xi: f(xi, u_seq[t], p, t * pf.Ts))(xf)
        zp = xpred @ Linv.T
        zb = (xb - mu) @ Linv.T
        wb = (ws[t][None, :] - 0.5 * (zp * zp).sum(-1)[None, :]
              + zb @ zp.T - 0.5 * (zb * zb).sum(-1)[:, None])
        xb = draw(wb, xf)
        out.append(xb)
    return torch.stack(out[::-1]), ll


# ---------------------------------------------------------------------------
# Particle-sharded PF with kernel A's segment mode on every rank
# ---------------------------------------------------------------------------


def pf_sharded_scan_supported(pf, n_devices: int) -> bool:
    """Static admission of :func:`sharded_pf_loglik_fused`: N divisible by
    the ranks, and kernel A's (``pf_scan_supported``); the port's kernel
    has no on-chip memory envelope to check per rank."""
    from ..kernels.pf_scan import pf_scan_supported

    return pf.N % n_devices == 0 and pf_scan_supported(pf)


def sharded_pf_loglik_fused(pf, u, y, generator, mesh: Mesh,
                            segment: int = 32, p=None):
    """Bootstrap-PF log-likelihood with the cloud sharded over ``mesh``,
    each rank advancing its [N/size, nx] block one segment of ``segment``
    steps at a time through kernel A's segment mode (``pf_scan(...,
    segment=True)``, as ``pf_segment_fused`` runs it: resampling-free, no
    collectives; its plain twin on CPU tensors or when autograd
    records).  Between segments one pmax and one psum turn the ranks'
    carried weights into the segment's global log-likelihood (the
    telescoped lse difference, exact for any resampling schedule) and
    globally normalized weights, and the Neff-gated distributed exchange
    (:func:`_resample_distributed`) resamples across ranks.  The data is
    NaN-padded to whole segments (missing steps are ll-neutral).
    Kernel A's admission and its per-step coefficients are computed once
    a call.  ``generator`` must be seeded alike on every rank.  Returns
    the replicated total ll (float32).  ``p`` must be the filter's own.

    ``segment`` trades the boundary work (collectives, host syncs) against
    the estimator: the ll stays unbiased for any resampling schedule, but
    its variance and log-domain bias grow with the resampling-free span.
    On the benchmark's 2-state model at N = 1e5, T = 1000 (CPU, the JAX
    package's function and this one) 32-step segments read 1-3 % below
    the exact ll, 8-step ones within 0.2 %."""
    from ..kernels import pf_scan as k

    if p is not None and p is not pf.p:
        raise ValueError("sharded_pf_loglik_fused takes the filter's p")
    _on_mesh(mesh, y)
    D = mesh.size
    if pf.N % D:
        raise ValueError(f"N={pf.N} is not divisible by {D} ranks")
    y = y.to(torch.float32)
    T, ny = y.shape
    nseg = -(-T // segment)
    pad = nseg * segment - T
    ypad = torch.cat([y, y.new_full((pad, ny), float("nan"))])
    u_seq = _as_u_seq(u, T, torch.float32, y.device).to(torch.float32)
    upad = torch.cat([u_seq, u_seq.new_zeros((pad, u_seq.shape[1]))])
    coef = k.affine_admission(pf, upad, ypad)
    if coef is None:
        raise ValueError("kernel A does not admit this filter and data (see "
                         "kernels/pf_scan.py::kernel_admits)")
    # the twin when autograd records: the kernel is forward-only
    scan = k.pf_scan_plain if _needs_grad(pf, upad, ypad, coef) else k.pf_scan
    ys, cs, *dens_in = k.scan_inputs(pf, upad, ypad, coef)
    dens = k.scan_density(pf, y.device)
    M = pf.N // D
    base_seed = seed_from_generator(generator)
    x = pf.initial_density.sample(_rank_generator(generator, mesh, y.device),
                                  (M,)).to(torch.float32)
    w = torch.full((M,), -math.log(pf.N), dtype=torch.float32,
                   device=y.device)
    ll = torch.zeros((), dtype=torch.float32, device=y.device)
    for s in range(nseg):
        sl = slice(s * segment, (s + 1) * segment)
        seed = (base_seed + 7919 * (mesh.rank * nseg + s)) % 2**63
        out = scan(ys[sl], cs[sl], *dens_in, N=M,
                   thresh=float(pf.resample_threshold), seed=seed, x0=x,
                   w0=w, dens=dens, segment=True)
        x = out["x_fin"]
        w, we, lse = _normalized(out["w_fin"] + out["ll"], mesh)
        ll = ll + lse
        if s + 1 < nseg:   # the last exchange would change nothing of ll
            st = PFState(x=x, w=w, we=we, t=s, generator=generator)
            x, w, _ = _resample_distributed(st, pf, mesh,
                                            _uniform(generator, (), w))
    return ll


# ---------------------------------------------------------------------------
# Time-sharded Kalman filter and RTS smoother
# ---------------------------------------------------------------------------


def _eye_like(nx: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(nx, dtype=like.dtype, device=like.device)


def sharded_filter_scan(A, b, C, eta, J, mesh: Mesh):
    """Per-rank body: the inclusive prefix of the filtering elements
    sharded along time.  Local level: ``kernels/assoc_scan.
    filter_scan_full`` (kernel K's whole-element mode on CUDA f32, the
    Hillis–Steele twin otherwise).  Outer level: one all_gather of each
    rank's last combined element, the exclusive prefix of the ranks
    before this one, and one batched combine folding it into every local
    prefix.  Returns this rank's globally combined ``(A, b, C, eta, J)``
    blocks; ``b`` and ``C`` are the filtered means and covariances."""
    from ..kernels.assoc_scan import filter_scan_full

    T, nx = b.shape
    loc = filter_scan_full(A, b, C, eta, J)
    sizes = [nx * nx, nx, nx * nx, nx, nx * nx]
    last = torch.cat([e[-1].reshape(-1) for e in loc])
    gathered = [tuple(r.reshape(e.shape[1:]) for r, e in
                      zip(row.split(sizes), loc))
                for row in _all_gather(last, mesh)]
    z = b.new_zeros(nx)
    Z = b.new_zeros(nx, nx)
    mine = (_eye_like(nx, b), z, Z, z, Z)
    for d in range(mesh.rank):
        mine = _filter_combine(mine, gathered[d])
    mine = tuple(m.expand(T, *m.shape) for m in mine)
    return _filter_combine(mine, loc)


def _halo_prev(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The block shifted down one step, index 0 taking the last row of
    the previous rank (one send); rank 0's index 0 is zeros, which the
    callers mask with the prior."""
    if mesh.size == 1:
        prev = torch.zeros_like(x[-1])
    else:
        prev = _ppermute(x[-1], mesh,
                         [(d, d + 1) for d in range(mesh.size - 1)])
    return torch.cat([prev[None], x[:-1]])


def _time_sharded_filter_local(F, c, H, Q, R, y_eff, m0, P0, mesh: Mesh):
    """Per-rank Kalman filter: the LOCAL elements (the transition entering
    element k is step k−1's, from :func:`_halo_prev`), the two-level scan
    (:func:`sharded_filter_scan`) and the log-likelihood from the shifted
    filtered moments, psum'd.  All inputs are this rank's [T/size, ...]
    blocks, so memory is O(T/size · nx²) a rank.  Returns ``(xt, Rt,
    ll)``."""
    nx = m0.shape[-1]
    Tl = y_eff.shape[0]
    first = (mesh.rank * Tl + torch.arange(Tl, device=y_eff.device)) == 0
    eye = _eye_like(nx, y_eff)
    Fp, cp, Qp = (_halo_prev(X, mesh) for X in (F, c, Q))
    S = symmetrize(H @ Qp @ H.mT) + R
    Sch = chol_lower(S)
    K = rdiv_chol(Qp @ H.mT, Sch)
    ImKH = eye - K @ H
    resid = y_eff - _mv_t(H, cp)
    A = ImKH @ Fp
    b = cp + _mv_t(K, resid)
    C = symmetrize(ImKH @ Qp)
    HtSinv = rdiv_chol(H.mT, Sch)
    eta = _mv_t(Fp.mT @ HtSinv, resid)
    J = symmetrize(Fp.mT @ HtSinv @ H @ Fp)
    # global element 0: the measurement update of the prior (only rank 0's
    # mask selects it)
    S0 = symmetrize(H[0] @ P0 @ H[0].T) + R[0]
    K0 = rdiv_chol(P0 @ H[0].T, chol_lower(S0))
    b0 = m0 + K0 @ (y_eff[0] - H[0] @ m0)
    C0 = symmetrize((eye - K0 @ H[0]) @ P0)
    mM, mV = first[:, None, None], first[:, None]
    A = torch.where(mM, 0.0, A)
    b = torch.where(mV, b0, b)
    C = torch.where(mM, C0, C)
    eta = torch.where(mV, 0.0, eta)
    J = torch.where(mM, 0.0, J)

    _, xt, Rt, _, _ = sharded_filter_scan(A, b, C, eta, J, mesh)

    xtp, Rtp = _halo_prev(xt, mesh), _halo_prev(Rt, mesh)
    x_pred = torch.where(mV, m0, _mv_t(Fp, xtp) + cp)
    R_pred = torch.where(mM, P0, Fp @ Rtp @ Fp.mT + Qp)
    e = y_eff - _mv_t(H, x_pred)
    lls = mvnormal_logpdf_cov(e, torch.zeros_like(e),
                              H @ R_pred @ H.mT + R)
    return xt, Rt, _psum(lls.sum(), mesh)


def _resolve_time_seqs(kf, u, y, mesh: Mesh):
    """This rank's [T/size, ...] blocks of the system matrices (F, c = B u,
    H, Q, R), of the effective measurement y − D u, and the prior: only
    the rank's own steps are resolved (a constant matrix as a view)."""
    _on_mesh(mesh, y)
    T = y.shape[0]
    if T % mesh.size:
        raise ValueError(f"T={T} is not divisible by {mesh.size} ranks")
    Tl = T // mesh.size
    t0, t1 = mesh.rank * Tl, (mesh.rank + 1) * Tl
    u_loc = _as_u_seq(u, T, y.dtype, y.device)[t0:t1]
    y_loc = y[t0:t1]
    m0, P0 = kf.d0.mean, kf.d0.cov
    tvec = torch.arange(t0, t1, dtype=y.dtype, device=y.device) * kf.Ts

    def block(M):
        if isinstance(M, FnMat):  # evaluated at the rank's own steps
            return _resolve_seq(M, Tl, m0, u_loc, tvec, kf.p, kf.Ts)
        return None if M is None else _resolve_seq(M, t1, m0)[t0:]

    F, B, H, D, Q, R = (block(M) for M in (kf.A, kf.B, kf.C, kf.D, kf.R1,
                                           kf.R2))
    live = u_loc.shape[-1] > 0
    c = (_mv_t(B, u_loc) if B is not None and live
         else y.new_zeros((Tl, m0.shape[-1])))
    y_eff = y_loc - _mv_t(D, u_loc) if D is not None and live else y_loc
    return F, c, H, Q, R, y_eff, m0, P0


def time_sharded_parallel_kf(kf, u, y, mesh: Mesh, p=None):
    """O(log T) Kalman filtering with the TIME axis sharded over
    ``mesh``: each rank builds the elements of its own T/size steps,
    scans them (kernel K's whole-element mode on CUDA f32) and folds in
    the carry of the ranks before it.  ``u`` and ``y`` are the whole
    trajectory on every rank; T must be divisible by the mesh size.
    Returns ``(xt, Rt, ll)``: this rank's filtered means and covariances
    and the replicated log-likelihood.  ``p`` is accepted for the verb's
    signature; tensor matrices do not read it."""
    return _time_sharded_filter_local(*_resolve_time_seqs(kf, u, y, mesh),
                                      mesh)


def _time_sharded_smooth_local(F, c, H, Q, R, y_eff, m0, P0, mesh: Mesh):
    """Per-rank RTS smoother: the sharded filter, the local smoothing
    elements (the step-k transition, unshifted), the local reverse scan
    (the Hillis–Steele ``associative_scan``: the JAX package's is an XLA
    scan, not a Pallas kernel) and the suffix of the ranks after this
    one, folded in (one all_gather of their first combined elements)."""
    xt, Rt, ll = _time_sharded_filter_local(F, c, H, Q, R, y_eff, m0, P0,
                                            mesh)
    nx = m0.shape[-1]
    Tl = xt.shape[0]
    D = mesh.size
    glast = (mesh.rank * Tl + torch.arange(Tl, device=xt.device)) == D * Tl - 1
    Pp = symmetrize(F @ Rt @ F.mT) + Q
    E = rdiv_chol(Rt @ F.mT, chol_lower(Pp))
    g = xt - _mv_t(E, _mv_t(F, xt) + c)
    L = symmetrize(Rt - E @ F @ Rt)
    mM, mV = glast[:, None, None], glast[:, None]
    E = torch.where(mM, 0.0, E)
    g = torch.where(mV, xt, g)
    L = torch.where(mM, Rt, L)
    loc = associative_scan(lambda a, b: _smooth_combine(b, a), (E, g, L),
                           reverse=True)
    sizes = [nx * nx, nx, nx * nx]
    head = torch.cat([e[0].reshape(-1) for e in loc])
    gathered = [tuple(r.reshape(e.shape[1:]) for r, e in
                      zip(row.split(sizes), loc))
                for row in _all_gather(head, mesh)]
    mine = (_eye_like(nx, g), g.new_zeros(nx), g.new_zeros(nx, nx))
    for d in range(D - 1, mesh.rank, -1):
        mine = _smooth_combine(gathered[d], mine)
    mine = tuple(m.expand(Tl, *m.shape) for m in mine)
    _, xT, RT = _smooth_combine(loc, mine)
    return xT, RT, xt, Rt, ll


def time_sharded_parallel_smooth(kf, u, y, mesh: Mesh, p=None):
    """O(log T) RTS smoothing with the TIME axis sharded over ``mesh``
    (the time-sharded ``smooth(kf, ...)``): the time-sharded filter and
    the reverse smoothing scan on each rank's block.  Returns ``(xT, RT,
    xt, Rt, ll)``: this rank's smoothed and filtered moments and the
    replicated log-likelihood."""
    return _time_sharded_smooth_local(*_resolve_time_seqs(kf, u, y, mesh),
                                      mesh)
