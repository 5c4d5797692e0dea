"""PyTorch port: kernel K's plain twin (kernels/assoc_scan.py) against the
JAX package's scans.

The twin is the Hillis–Steele scan that CPU tensors take.  It is held
against ``jax.lax.associative_scan`` of the same plane combine (the JAX
CPU route) and against one interpret-mode call of the JAX Pallas kernel
``filter_scan`` at nx = 2, T = 64, L = 8 (eight blocks, so the kernel's
carry across blocks is exercised).  float32, rtol 2e-4, atol 2e-5, as
tests/test_assoc_scan_kernel.py holds the Pallas kernel: the scans
associate the combines in different orders."""
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
