"""PyTorch port: ``utils/plotting.py`` against the JAX package on the same
numpy inputs in float64 (matplotlib's Agg backend): for
``plot_solution``, ``plot_smoothing``, ``plot_particles``,
``validationplot``, ``covplot``, ``unscentedplot`` and ``densityplot``,
the two figures hold the same number of axes and of lines, and each
line's data is equal within 1e-10."""
import jax
import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch
from _torch_parity import A, B, C, R1, R2

import lowlevelparticlefilters_jl_tpu as llpf
import lowlevelparticlefilters_jl_tpu_torch as llpt
from lowlevelparticlefilters_jl_tpu_torch import convert

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

T, N = 60, 200


def _data():
    rng = np.random.default_rng(5)
    u = 0.3 + 0.5 * rng.normal(size=(T, 1))
    y = rng.normal(size=(T, 2))
    x = rng.normal(size=(T, N, 2))
    w = rng.normal(size=(T, N))
    we = np.exp(w) / np.exp(w).sum(-1, keepdims=True)
    return u, y, x, np.log(we), we


def _kfs():
    kj = llpf.KalmanFilter(*(jnp.asarray(M) for M in (A, B, C)), 0,
                           jnp.asarray(R1), jnp.asarray(R2))
    kt = convert.kalman_filter_from_numpy(A, B, C, 0, R1, R2, device="cpu")
    return kj, kt


def _fig(obj):
    return obj if isinstance(obj, matplotlib.figure.Figure) else obj.figure


@pytest.fixture(scope="module")
def sols():
    """Each package's KF and smoothing solutions of the same data."""
    u, y, *_ = _data()
    kj, kt = _kfs()
    uj, yj = jnp.asarray(u), jnp.asarray(y)
    ut, yt = torch.tensor(u), torch.tensor(y)
    return {"jax": (kj, *jax.jit(lambda u, y: (
                llpf.forward_trajectory(kj, u, y), llpf.smooth(kj, u, y)))(
                    uj, yj)),
            "torch": (kt, llpt.forward_trajectory(kt, ut, yt),
                      llpt.smooth(kt, ut, yt))}


@pytest.fixture
def jitted(monkeypatch):
    """The JAX package's statistics under jit inside its plots: eagerly
    each lag's slice and each op compiles apart."""
    from lowlevelparticlefilters_jl_tpu import trajectory
    from lowlevelparticlefilters_jl_tpu.models import sigmapoints
    from lowlevelparticlefilters_jl_tpu.utils import plotting

    monkeypatch.setattr(plotting, "validation_stats", jax.jit(
        plotting.validation_stats, static_argnames=("sigma", "maxlag")))
    monkeypatch.setattr(plotting, "kde", jax.jit(
        plotting.kde, static_argnames=("npoints",)))
    for name in ("weighted_mean", "weighted_quantile"):
        monkeypatch.setattr(trajectory, name,
                            jax.jit(getattr(trajectory, name)))
    monkeypatch.setattr(sigmapoints, "sigmapoints",
                        jax.jit(sigmapoints.sigmapoints, static_argnums=2))


def _plots(pkg, name, sols):
    """The figure ``name`` draws with package ``pkg`` ("jax" or "torch")."""
    u, y, x, w, we = _data()
    kf, sol, ssol = sols[pkg]
    lib, arr = (llpf, jnp.asarray) if pkg == "jax" else (llpt, torch.tensor)
    pl = lib.plotting
    if name == "plot_solution":
        return pl.plot_solution(sol, plot_predictions=True)
    if name == "plot_smoothing":
        return pl.plot_smoothing(ssol)
    if name == "plot_particles":
        psol = lib.ParticleFilteringSolution(u=arr(u), y=arr(y), x=arr(x),
                                             w=arr(w), we=arr(we),
                                             ll=arr(0.0))
        return pl.plot_particles(psol)
    if name == "validationplot":
        return lib.validationplot(sol)
    if name == "covplot":
        return lib.covplot(arr(np.array([0.5, -1.0])), sol.Rt[10])
    if name == "unscentedplot":
        return lib.unscentedplot(kf.init().replace(
            x=arr(np.array([0.2, 0.1])), R=sol.Rt[5]))
    if name == "densityplot":
        return lib.densityplot(arr(x[3, :, 0]), arr(we[3]), npoints=50)
    raise KeyError(name)
@pytest.mark.parametrize("name", [
    "plot_solution", "plot_smoothing", "plot_particles", "validationplot",
    "covplot", "unscentedplot", "densityplot"])
def test_figures_match_jax(name, sols, jitted):
    try:
        want = _fig(_plots("jax", name, sols))
        got = _fig(_plots("torch", name, sols))
        assert len(got.axes) == len(want.axes)
        for ag, aw in zip(got.axes, want.axes):
            lg, lw = ag.get_lines(), aw.get_lines()
            assert len(lg) == len(lw)
            for a, b in zip(lg, lw):
                np.testing.assert_allclose(
                    np.asarray(a.get_xydata(), dtype=np.float64),
                    np.asarray(b.get_xydata(), dtype=np.float64),
                    rtol=1e-10, atol=1e-12, err_msg=name)
        assert sum(len(a.get_lines()) for a in got.axes) > 0
    finally:
        plt.close("all")
