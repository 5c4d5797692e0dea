"""PyTorch port: kernel K's plain twin (kernels/assoc_scan.py) against the
JAX package's scans.

The twin is the Hillis–Steele scan that CPU tensors take.  It is held
against ``jax.lax.associative_scan`` of the same plane combine (the JAX
CPU route) and against one interpret-mode call of the JAX Pallas kernel
``filter_scan`` at nx = 2, T = 64, L = 8 (eight blocks, so the kernel's
carry across blocks is exercised).  float32, rtol 2e-4, atol 2e-5, as
tests/test_assoc_scan_kernel.py holds the Pallas kernel: the scans
associate the combines in different orders.

The CUDA kernel's own association (csrc/assoc_scan.cu: runs of L steps a
thread, a Kogge-Stone scan of a block's runs, groups of blocks folded and
scanned, the prefixes combined on the left) is written out here in plain
PyTorch at small grids and held against ``jax.lax.associative_scan`` in
the three modes, so an ordering mistake shows before the card."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import np_of

from lowlevelparticlefilters_jl_tpu.ops.pallas import assoc_scan as jas
from lowlevelparticlefilters_jl_tpu.parallel import temporal as jtp
from lowlevelparticlefilters_jl_tpu_torch.kernels import assoc_scan as tas
from lowlevelparticlefilters_jl_tpu_torch.parallel import temporal as tp

RTOL, ATOL = 2e-4, 2e-5


def _psd(rng, T, nx, scale):
    h = rng.normal(size=(T, nx, nx)) * 0.3
    return (h @ np.swapaxes(h, -1, -2) + scale * np.eye(nx)).astype(
        np.float32)


def _filter_elems(T, nx, seed):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=(T, nx, nx)) * 0.3).astype(np.float32),
            rng.normal(size=(T, nx)).astype(np.float32), _psd(rng, T, nx, 0.1),
            rng.normal(size=(T, nx)).astype(np.float32),
            _psd(rng, T, nx, 0.1))


def _smooth_elems(T, nx, seed):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=(T, nx, nx)) * 0.4).astype(np.float32),
            rng.normal(size=(T, nx)).astype(np.float32), _psd(rng, T, nx, 0.0))


def _planes(arrays, lib):
    """[T, ...] stacks -> the plane structure, in ``lib``'s tensors."""
    out = []
    for a in arrays:
        a = lib(a)
        if a.ndim == 3:
            out.append(tuple(tuple(a[:, i, j] for j in range(a.shape[2]))
                             for i in range(a.shape[1])))
        else:
            out.append(tuple(a[:, i] for i in range(a.shape[1])))
    return tuple(out)


def _stack(m, M):
    return (np.stack([np_of(v) for v in m], -1),
            np.stack([np.stack([np_of(v) for v in r], -1) for r in M], -2))


@pytest.mark.parametrize("nx,T", [(2, 200), (3, 37)])
def test_filter_twin_matches_jax_associative_scan(nx, T):
    el = _filter_elems(T, nx, seed=nx * 1000 + T)
    want = jax.lax.associative_scan(jtp._filter_combine_soa,
                                    _planes(el, jnp.asarray))
    got = tas.filter_scan_p(_planes(el, torch.tensor))
    for w, g in zip(_stack(want[1], want[2]), _stack(*got)):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("nx,T", [(2, 120), (3, 37)])
def test_smooth_twin_matches_jax_reverse_scan(nx, T):
    el = _smooth_elems(T, nx, seed=nx * 77 + T)
    want = jax.lax.associative_scan(
        lambda a, b: jtp._smooth_combine_soa(b, a), _planes(el, jnp.asarray),
        reverse=True)
    got = tas.smooth_scan_p(_planes(el, torch.tensor))
    for w, g in zip(_stack(want[1], want[2]), _stack(*got)):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def test_filter_twin_matches_pallas_kernel():
    el = _filter_elems(64, 2, seed=11)
    xt_j, Rt_j = jas.filter_scan(*(jnp.asarray(a) for a in el), L=8,
                                 interpret=True)
    xt_t, Rt_t = tas.filter_scan(*(torch.tensor(a) for a in el))
    np.testing.assert_allclose(np_of(xt_t), np_of(xt_j), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(np_of(Rt_t), np_of(Rt_j), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("nx", [1, 2, 4, 8])
def test_element_layout_matches_jax(nx):
    """The CUDA kernel reads element records in the JAX kernel's flat
    plane order (matrices row-major, fields in order); here the layout
    helpers agree with the JAX module's."""
    for kind, struct in ((tas.FILTER, jas._struct_filter(nx)),
                         (tas.SMOOTH, jas._struct_smooth(nx))):
        E = jas._nplanes(struct)
        assert tas.n_elements(nx, kind) == E
        flat = list(range(E))
        assert tp._leaves(jas._unflatten(flat, struct)) == flat
    m, M = tas._split_out(torch.arange(3 * (nx + nx * nx)).reshape(
        3, nx + nx * nx), nx)
    assert [int(v[0]) for v in m] == list(range(nx))
    assert int(M[nx - 1][0][0]) == nx + (nx - 1) * nx


def test_kernel_gate():
    x = torch.zeros(4)
    assert not tas.scan_supported(2, x)
    with pytest.raises(TypeError):
        tas._kernel_scan(((x,), (x,)), tas.FILTER)


def _kernel_order_scan(combine, step_of, T, B, most):
    """Kernel K's association at a grid of at most ``most`` blocks of
    ``B`` threads: the list of inclusive prefixes by scan position.
    ``step_of(k)`` is the element at scan position k."""
    L = -(-T // (most * B))
    G = -(-T // (B * L))

    def kogge_stone(vals):   # at distance d, t takes (t - d) on its left
        v, d = list(vals), 1
        while d < len(v):
            v = [v[t] if t < d else combine(v[t - d], v[t])
                 for t in range(len(v))]
            d *= 2
        return v

    def fold(vals):
        a = vals[0]
        for v in vals[1:]:
            a = combine(a, v)
        return a

    runs = [[step_of(k) for k in range(g * L, min(g * L + L, T))]
            for g in range(-(-T // L))]
    blocks = [kogge_stone([fold(r) for r in runs[b * B:b * B + B]])
              for b in range(G)]
    s = -(-G // B)
    out = []
    for b, inc in enumerate(blocks):
        before = None
        if b > 0:
            aggs = [blk[-1] for blk in blocks[:b]]
            before = kogge_stone([fold(aggs[i:i + s])
                                  for i in range(0, b, s)])[-1]
        for t, run in enumerate(runs[b * B:b * B + B]):
            mine = inc[t - 1] if t > 0 else None
            pre = (combine(before, mine) if before is not None
                   and mine is not None else before if before is not None
                   else mine)
            for el in run:
                pre = el if pre is None else combine(pre, el)
                out.append(pre)
    return out


_T_MAX = 50


@functools.lru_cache(maxsize=None)
def _reference(family, nx):
    """The elements at T = 50 and their inclusive scan (f32 numpy): JAX's
    ``associative_scan`` (jitted) at nx = 2, the port's Hillis–Steele twin
    at the other nx (held against JAX by the tests above)."""
    if family == "smooth":
        el = _smooth_elems(_T_MAX, nx, seed=nx + 500)
        if nx == 2:
            want = jax.jit(lambda e: jax.lax.associative_scan(
                lambda a, b: jtp._smooth_combine(b, a), e, reverse=True))(
                tuple(jnp.asarray(a) for a in el))
        else:
            want = tp.associative_scan(
                lambda a, b: tp._smooth_combine(b, a),
                tuple(torch.tensor(a) for a in el), reverse=True)
    else:
        el = _filter_elems(_T_MAX, nx, seed=nx + 400)
        if nx == 2:
            want = jax.jit(lambda e: jax.lax.associative_scan(
                jtp._filter_combine, e))(tuple(jnp.asarray(a) for a in el))
        else:
            want = tp.associative_scan(tp._filter_combine,
                                       tuple(torch.tensor(a) for a in el))
    return el, tuple(np_of(w) for w in want)


@pytest.mark.parametrize("kind", ["filter", "smooth", "full"])
@pytest.mark.parametrize("nx", [1, 2, 3, 4])
def test_kernel_association_matches_jax(kind, nx):
    """K's association against JAX's scan (at nx = 2; the twin's at the
    other nx, see ``_reference``), float32, rtol 2e-4, atol 2e-5:
    at 4-thread blocks on a grid of 3, T around a thread's run (15-17)
    and a block's tile (T = 12 L, +- 1) and 3 tiles + 5 (T = 41), and at
    2-thread blocks on a grid of 5 (T = 23, 50), where each block folds
    groups of 2 and 3 earlier blocks.  The smoother scans the last T
    elements from the end, the filter the first T."""
    el, want = _reference("smooth" if kind == "smooth" else "filter", nx)
    combine = ((lambda a, b: tp._smooth_combine(b, a)) if kind == "smooth"
               else tp._filter_combine)
    parts = (1, 2) if kind != "full" else range(len(el))
    for B, most, T in [(4, 3, t) for t in (1, 11, 12, 13, 15, 16, 17, 41)] \
            + [(2, 5, 23), (2, 5, 50)]:
        lo = _T_MAX - T if kind == "smooth" else 0
        stacks = tuple(torch.tensor(a[lo:lo + T]) for a in el)
        if kind == "smooth":
            def step_of(k):
                return tuple(a[T - 1 - k:T - k] for a in stacks)
        else:
            def step_of(k):
                return tuple(a[k:k + 1] for a in stacks)
        got = _kernel_order_scan(combine, step_of, T, B, most)
        if kind == "smooth":
            got = got[::-1]
        for i in parts:
            g = torch.cat([o[i] for o in got]).numpy()
            w = want[i][lo:lo + T]
            np.testing.assert_allclose(
                g, w, rtol=RTOL, atol=ATOL * (1 if kind != "full"
                                              else 1 + np.abs(w).max()),
                err_msg=f"B={B} grid={most} T={T} part {i}")
