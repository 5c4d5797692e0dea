"""Matplotlib rendering of solution objects and filter diagnostics
(counterpart of ``utils/plotting.py``).

The reference's Plots.jl recipes:
- `plot_solution` — KalmanFilteringSolution recipe with ±2σ covariance
  ribbons (solutions.jl:83-195),
- `plot_smoothing` — smoothed-vs-filtered recipe (solutions.jl:242-307),
- `plot_particles` — particle-trajectory quantile bands
  (solutions.jl:354-487),
- `validationplot` — innovation RMS / NIS-χ² / autocorrelation /
  input cross-correlation panel
  (ext/LowLevelParticleFiltersDistributionsExt.jl:106-238),
- `covplot` / `unscentedplot` — covariance ellipses and sigma points
  (ext/LowLevelParticleFiltersPlotsExt.jl:129-226),
- `debugplot` — per-step particle densities
  (ext/LowLevelParticleFiltersPlotsExt.jl:66-120, non-interactive frames).

Every function imports matplotlib when called (the Agg backend unless
one is set), so the package imports without it.  The statistics run on
the tensors' device (utils/diagnostics.py, trajectory.py); tensors move
to the host with ``.detach().cpu().numpy()`` where they are drawn.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .diagnostics import kde, validation_stats


def _plt():
    try:
        import matplotlib

        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        return plt
    except ImportError as e:  # pragma: no cover
        raise ImportError("plotting requires matplotlib") from e


def _np(v) -> np.ndarray:
    """``v`` on the host as numpy."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _t(v) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(
        np.asarray(v))


def plot_solution(sol, *, plot_predictions=False, ribbon: float = 2.0,
                  xreal=None, axes=None):
    """KF-solution plot with filtered means and ±ribbon·σ bands
    (solutions.jl:83-195).  Returns the matplotlib figure."""
    plt = _plt()
    xt = _np(sol.xt)
    Rt = _np(sol.Rt)
    t = (_np(sol.t) if getattr(sol, "t", None) is not None
         else np.arange(len(xt)))
    T, nx = xt.shape
    if axes is None:
        fig, axes = plt.subplots(nx, 1, figsize=(8, 2.2 * nx), squeeze=False)
        axes = axes[:, 0]
    else:
        fig = axes[0].figure
    sd = np.sqrt(np.maximum(np.diagonal(Rt, axis1=-2, axis2=-1), 0.0))
    for i, ax in enumerate(axes):
        ax.fill_between(t, xt[:, i] - ribbon * sd[:, i],
                        xt[:, i] + ribbon * sd[:, i],
                        alpha=0.25, label=f"±{ribbon}σ")
        ax.plot(t, xt[:, i], label="filtered")
        if plot_predictions:
            ax.plot(t, _np(sol.x)[:, i], ":", label="predicted")
        if xreal is not None:
            ax.plot(t, _np(xreal)[:, i], "--", label="true")
        ax.set_ylabel(f"x{i+1}")
        ax.legend(loc="best", fontsize=8)
    axes[-1].set_xlabel("time")
    return fig


def plot_smoothing(ssol, *, ribbon: float = 2.0, xreal=None):
    """Smoothed vs filtered trajectories (solutions.jl:242-307)."""
    plt = _plt()
    sol = ssol.sol
    xT = _np(ssol.xT)
    RT = _np(ssol.RT)
    fig = plot_solution(sol, ribbon=ribbon, xreal=xreal)
    t = (_np(sol.t) if getattr(sol, "t", None) is not None
         else np.arange(len(xT)))
    sd = np.sqrt(np.maximum(np.diagonal(RT, axis1=-2, axis2=-1), 0.0))
    for i, ax in enumerate(fig.axes):
        ax.plot(t, xT[:, i], "-", lw=2, label="smoothed")
        ax.fill_between(t, xT[:, i] - ribbon * sd[:, i],
                        xT[:, i] + ribbon * sd[:, i],
                        alpha=0.15)
        ax.legend(loc="best", fontsize=8)
    return fig


def plot_particles(sol, *, q=(0.025, 0.975), xreal=None, heatmap=False,
                   nbinsy: int = 30):
    """Particle-solution plot (solutions.jl:354-487).

    Default: weighted mean + quantile band per state (the recipe's
    ``q=...`` mode).  ``heatmap=True`` renders the recipe's default
    mode instead: a per-dimension weighted 2-D histogram of the whole
    particle cloud over (time, value) with ``nbinsy`` value bins —
    the full filtering density, not just summary statistics.
    """
    plt = _plt()
    from ..trajectory import weighted_mean, weighted_quantile

    x = _np(sol.x)   # [T, N, nx]
    we = _np(sol.we)
    T, N, nx = x.shape

    fig, axes = plt.subplots(nx, 1, figsize=(8, 2.2 * nx), squeeze=False)
    t = np.arange(T)
    if heatmap:
        for i in range(nx):
            ax = axes[i, 0]
            xi = x[:, :, i]
            lo, hi = float(xi.min()), float(xi.max())
            edges = np.linspace(lo, hi + 1e-12, nbinsy + 1)
            # weighted per-step histogram [T, nbinsy]
            bins = np.clip(np.digitize(xi, edges) - 1, 0, nbinsy - 1)
            H = np.zeros((T, nbinsy))
            rows = np.repeat(t, N)
            np.add.at(H, (rows, bins.ravel()), we.ravel())
            ax.pcolormesh(t, 0.5 * (edges[:-1] + edges[1:]), H.T,
                          cmap="viridis", shading="nearest")
            if xreal is not None:
                ax.plot(t, _np(xreal)[:, i], "r--", lw=1, label="true")
                ax.legend(loc="best", fontsize=8)
            ax.set_ylabel(f"x{i+1}")
        axes[-1, 0].set_xlabel("time")
        return fig

    xs, ws = _t(sol.x), _t(sol.we)
    m = _np(weighted_mean(xs, ws))
    qlo = _np(weighted_quantile(xs, ws, q[0]))
    qhi = _np(weighted_quantile(xs, ws, q[1]))
    for i in range(nx):
        ax = axes[i, 0]
        ax.fill_between(t, qlo[:, i], qhi[:, i], alpha=0.25,
                        label=f"{100*(q[1]-q[0]):.0f}% band")
        ax.plot(t, m[:, i], label="weighted mean")
        if xreal is not None:
            ax.plot(t, _np(xreal)[:, i], "--", label="true")
        ax.set_ylabel(f"x{i+1}")
        ax.legend(loc="best", fontsize=8)
    axes[-1, 0].set_xlabel("time")
    return fig


def densityplot(x, we=None, *, ax=None, npoints: int = 200, **kw):
    """Weighted kernel-density plot of a particle marginal
    (src/plotting.jl:49-60 `densityplot` recipe).

    ``x``: [N] samples (one state dimension), ``we``: normalized weights
    (uniform if None).
    """
    plt = _plt()
    grid, dens = kde(_t(x).reshape(-1),
                     None if we is None else _t(we).reshape(-1),
                     npoints=npoints)
    if ax is None:
        _, ax = plt.subplots(figsize=(6, 3))
    ax.plot(_np(grid), _np(dens), **kw)
    ax.fill_between(_np(grid), 0, _np(dens), alpha=0.2)
    ax.set_ylabel("density")
    return ax


def validationplot(sol, sigma: float = 0.95):
    """Four-panel statistical validation (DistributionsExt.jl:106-238):
    innovation RMS, NIS vs χ² bounds, autocorrelation, input
    cross-correlation."""
    plt = _plt()
    stats = validation_stats(sol, sigma=sigma)
    fig, axes = plt.subplots(2, 2, figsize=(11, 8))
    e = _np(sol.e)
    T, ny = e.shape

    ax = axes[0, 0]
    ax.bar(np.arange(1, ny + 1), _np(stats["rms"]))
    ax.set_title("RMS of Innovation")
    ax.set_xlabel("Output")

    ax = axes[0, 1]
    if "nis" in stats:
        ax.plot(_np(stats["nis"]), ".", ms=3)
        lo, hi = stats["nis_bounds"]
        ax.axhline(lo, ls="--", c="k")
        ax.axhline(hi, ls="--", c="k", label=f"{100*sigma:.0f}% bounds")
        ax.legend(fontsize=8)
    ax.set_title("Normalized Innovation Squared (NIS)")
    ax.set_xlabel("Time")

    ax = axes[1, 0]
    acf = _np(stats["autocorrelation"])
    for i in range(ny):
        ax.stem(np.arange(acf.shape[0]), acf[:, i],
                label=f"y{i+1}", basefmt=" ")
    b = stats["whiteness_bound"]
    ax.axhline(b, ls="--", c="k")
    ax.axhline(-b, ls="--", c="k")
    ax.set_title("Innovation Autocorrelation")
    ax.set_xlabel("Lag")
    ax.legend(fontsize=8)

    ax = axes[1, 1]
    if "crosscorrelation" in stats:
        ccf = _np(stats["crosscorrelation"])  # [lag, nu, ny]
        for i in range(ccf.shape[2]):
            for j in range(ccf.shape[1]):
                ax.stem(np.arange(1, ccf.shape[0] + 1), ccf[:, j, i],
                        label=f"e{i+1}-u{j+1}", basefmt=" ")
        ax.axhline(b, ls="--", c="k")
        ax.axhline(-b, ls="--", c="k")
        ax.legend(fontsize=8)
    ax.set_title("Innovation-Input Cross-correlation")
    ax.set_xlabel("Lag")
    fig.tight_layout()
    return fig


def covplot(mu, Sigma, *, dims=(0, 1), nsigma: float = 2.0, ax=None, **kw):
    """Covariance ellipse of a 2-D marginal (PlotsExt.jl:190-226)."""
    plt = _plt()
    mu = _np(mu)
    S = _np(Sigma)[np.ix_(dims, dims)]
    vals, vecs = np.linalg.eigh(S)
    th = np.linspace(0, 2 * np.pi, 100)
    circ = np.stack([np.cos(th), np.sin(th)])
    ell = (vecs * np.sqrt(np.maximum(vals, 0))) @ circ * nsigma
    if ax is None:
        _, ax = plt.subplots()
    ax.plot(mu[dims[0]] + ell[0], mu[dims[1]] + ell[1], **kw)
    ax.plot([mu[dims[0]]], [mu[dims[1]]], "+", c=ax.lines[-1].get_color())
    return ax


def unscentedplot(ukf_or_state, state=None, *, dims=(0, 1),
                  nsigma: float = 2.0, ax=None):
    """Sigma points + the covariance ellipse they imply
    (PlotsExt.jl:129-189)."""
    plt = _plt()
    from ..models.sigmapoints import sigmapoints, TrivialParams

    if state is None:
        x, R = ukf_or_state.x, ukf_or_state.R
        wp = TrivialParams()
    else:
        x, R = state.x, state.R
        wp = getattr(ukf_or_state, "weight_params", TrivialParams())
    pts = _np(sigmapoints(_t(x), _t(R), wp))
    if ax is None:
        _, ax = plt.subplots()
    ax.scatter(pts[:, dims[0]], pts[:, dims[1]], marker="x",
               label="sigma points")
    covplot(_np(x), _np(R), dims=dims, nsigma=nsigma, ax=ax,
            label=f"{nsigma}σ ellipse")
    ax.legend(fontsize=8)
    return ax


def debugplot(pf, sol, *, steps=None, dim: int = 0, xreal=None):
    """Static analogue of the reference's interactive particle debugger
    (PlotsExt.jl:66-120): per-step weighted particle densities with the
    effective sample size in each panel title."""
    plt = _plt()
    from ..ops.logsumexp import effective_particles

    x, we = _t(sol.x), _t(sol.we)
    T = x.shape[0]
    if steps is None:
        steps = list(range(0, T, max(1, T // 6)))[:6]
    fig, axes = plt.subplots(len(steps), 1, figsize=(8, 1.8 * len(steps)),
                             squeeze=False)
    for ax, k in zip(axes[:, 0], steps):
        grid, dens = kde(x[k, :, dim], we[k])
        neff = float(effective_particles(we[k]))
        ax.fill_between(_np(grid), _np(dens), alpha=0.4)
        if xreal is not None:
            ax.axvline(_np(xreal)[k, dim], c="k", ls="--")
        ax.set_ylabel(f"t={k}\nNeff={neff:.0f}", fontsize=8)
    fig.suptitle(f"particle density, state dim {dim}")
    return fig


def commandplot(pf, sol, **kwargs):
    """Frame generator stepping through `debugplot` panels one step at a
    time — the non-interactive analogue of the reference's key-driven
    stepper (PlotsExt.jl:66-102).  Iterate to obtain figures.  For a
    live key-driven session use :func:`commandplot_interactive`."""
    T = sol.x.shape[0]
    for k in range(T):
        yield debugplot(pf, sol, steps=[k], **kwargs)


def commandplot_interactive(pf, sol, *, dim: int = 0, xreal=None):
    """Key-driven particle-cloud stepper — the interactive counterpart of
    the reference's commandplot (PlotsExt.jl:66-102: 'q' quits, any other
    input advances; here ←/'p' also steps back and 'q' closes).

    Binds matplotlib key events and redraws one `debugplot`-style panel
    in place.  Returns ``(fig, step_fn)`` — ``step_fn(delta)`` is the
    same redraw the key handler uses, so headless environments (and the
    tests) can drive the session programmatically.
    """
    plt = _plt()
    from ..ops.logsumexp import effective_particles

    x, we = _t(sol.x), _t(sol.we)
    T = x.shape[0]
    fig, ax = plt.subplots(figsize=(8, 3))
    state = {"k": 0}

    def step_fn(delta: int = 1):
        state["k"] = int(np.clip(state["k"] + delta, 0, T - 1))
        k = state["k"]
        ax.clear()
        grid, dens = kde(x[k, :, dim], we[k])
        neff = float(effective_particles(we[k]))
        ax.fill_between(_np(grid), _np(dens), alpha=0.4)
        if xreal is not None:
            ax.axvline(_np(xreal)[k, dim], c="k", ls="--")
        ax.set_title(f"t={k}/{T - 1}  Neff={neff:.0f}   "
                     "[→/n: forward, ←/p: back, q: quit]", fontsize=9)
        fig.canvas.draw_idle()
        return fig

    def _on_key(event):
        if event.key in ("q", "escape"):
            plt.close(fig)
        elif event.key in ("left", "p"):
            step_fn(-1)
        else:  # any other key advances (reference semantics)
            step_fn(+1)

    fig.canvas.mpl_connect("key_press_event", _on_key)
    step_fn(0)
    return fig, step_fn


def sampleplot(f, u, generator, n_runs: int = 10, p=None, dims=None,
               ax=None):
    """Prior-predictive check: overlay ``n_runs`` simulated state
    trajectories from the filter's generative model, drawn from
    ``generator`` (filtering.jl:479-525)."""
    plt = _plt()
    from ..trajectory import simulate_ensemble

    xs, _, _ = simulate_ensemble(f, u, generator, n_runs, p)
    xs = _np(xs)
    nx = xs.shape[-1]
    dims = range(nx) if dims is None else dims
    if ax is None:
        fig, axes = plt.subplots(len(list(dims)), 1, squeeze=False,
                                 figsize=(8, 2.0 * nx))
        axes = axes[:, 0]
    else:
        axes = [ax]
        fig = ax.figure
    for ax_i, d in zip(axes, dims):
        ax_i.plot(xs[:, :, d].T, alpha=0.5, lw=0.8)
        ax_i.set_ylabel(f"x{d+1}")
    fig.suptitle("prior predictive samples")
    return fig
