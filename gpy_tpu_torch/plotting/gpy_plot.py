"""Backend-agnostic model plots.

Reference: GPy/plotting/gpy_plot/ (gp_plots.py: plot/plot_f/plot_mean/
plot_confidence/plot_density/plot_samples/plot_errorbars_trainset;
data_plots.py: plot_data/plot_data_error/plot_inducing; latent_plots.py:
plot_latent/plot_latent_scatter/plot_magnification; kernel_plots.py:
plot covariance + plot_ARD). Counterpart of gpy_tpu/plotting/gpy_plot.py.
All drawing goes through the registered backend (see
__init__.change_plotting_library).

Grids are built in numpy on the host, sent to the model as tensors on its
device and dtype, and what the model returns comes back as numpy for the
backend (`_np`).
"""
from __future__ import annotations

import numpy as np
import torch

from ..util.misc import param_to_array as _np  # tensor, Param or array -> numpy
from . import tango


def _on(m, A) -> torch.Tensor:
    """The numpy grid A as a tensor on the device and dtype of m's
    parameters."""
    p = m._first_param()
    return torch.as_tensor(np.asarray(A), dtype=p.dtype, device=p.device)


def _lib():
    from . import plotting_library

    return plotting_library()


def _grid_for(m, plot_limits=None, resolution=200, visible_dims=None):
    X = _np(m.X)
    d = (visible_dims or [0])[0]
    if plot_limits is None:
        lo, hi = X[:, d].min(), X[:, d].max()
        pad = 0.15 * (hi - lo + 1e-9)
        lo, hi = lo - pad, hi + pad
    else:
        lo, hi = plot_limits
    xs = np.linspace(lo, hi, resolution)
    Xs = np.tile(X.mean(0), (resolution, 1))
    Xs[:, d] = xs
    return xs, Xs, d


def plot_mean(m, ax=None, plot_limits=None, resolution=200, visible_dims=None,
              color=tango.BLUE, label="mean", **kw):
    lib = _lib()
    canvas = lib.new_canvas(ax=ax)
    xs, Xs, _ = _grid_for(m, plot_limits, resolution, visible_dims)
    mu, _ = m.predict(_on(m, Xs))
    lib.plot(canvas, xs, _np(mu)[:, 0], color=color, label=label, lw=2)
    return lib.show_canvas(canvas)


def plot_confidence(m, ax=None, plot_limits=None, resolution=200,
                    visible_dims=None, lower=2.5, upper=97.5,
                    color=tango.BLUE_LIGHT, label="confidence", **kw):
    lib = _lib()
    canvas = lib.new_canvas(ax=ax)
    xs, Xs, _ = _grid_for(m, plot_limits, resolution, visible_dims)
    lo_q, hi_q = _quantiles(m, Xs, lower, upper)
    lib.fill_between(canvas, xs, lo_q[:, 0], hi_q[:, 0], color=color, label=label)
    return lib.show_canvas(canvas)


def plot_density(m, ax=None, plot_limits=None, resolution=200,
                 visible_dims=None, color=tango.BLUE_LIGHT, label="density", **kw):
    """Nested percentile bands 5..95 (GPy gp_plots.plot_density)."""
    lib = _lib()
    canvas = lib.new_canvas(ax=ax)
    xs, Xs, _ = _grid_for(m, plot_limits, resolution, visible_dims)
    percs = [5, 15, 25, 35, 45, 55, 65, 75, 85, 95]
    Xt = _on(m, Xs)
    bands = [_np(m.predict_quantiles(Xt, (p,))[0])[:, 0] for p in percs]
    lib.fill_gradient(canvas, xs, bands, color=color, label=label)
    return lib.show_canvas(canvas)


def _quantiles(m, Xs, lower, upper, Y_metadata=None):
    """The predictive quantiles, or mean -+ 1.96 sd for a model without
    predict_quantiles."""
    Xt = _on(m, Xs)
    if hasattr(m, "predict_quantiles"):
        qs = (m.predict_quantiles(Xt, (lower, upper), Y_metadata=Y_metadata)
              if Y_metadata else m.predict_quantiles(Xt, (lower, upper)))
        return _np(qs[0]), _np(qs[1])
    mu, var = m.predict(Xt)
    sd = np.sqrt(_np(var))
    return _np(mu) - 1.96 * sd, _np(mu) + 1.96 * sd


def plot_samples(m, ax=None, plot_limits=None, resolution=200,
                 visible_dims=None, samples=3, color=tango.BLUE, **kw):
    lib = _lib()
    canvas = lib.new_canvas(ax=ax)
    xs, Xs, _ = _grid_for(m, plot_limits, resolution, visible_dims)
    fs = _np(m.posterior_samples_f(_on(m, Xs), size=samples))
    for i in range(samples):
        lib.plot(canvas, xs, fs[:, 0, i], color=color, alpha=0.4, lw=0.9)
    return lib.show_canvas(canvas)


def plot_fit(m, ax=None, plot_limits=None, resolution=200, plot_data=True,
             plot_raw=False, visible_dims=None, samples=0, lower=2.5, upper=97.5,
             Y_metadata=None, **kw):
    """The flagship m.plot(): mean + confidence + data (+ samples).
    GPy: gp_plots.plot."""
    lib = _lib()
    canvas = lib.new_canvas(ax=ax)
    xs, Xs, d = _grid_for(m, plot_limits, resolution, visible_dims)
    Xt = _on(m, Xs)
    if plot_raw and hasattr(m, "predict_noiseless"):
        mu, var = m.predict_noiseless(Xt)
        sd = np.sqrt(_np(var))
        lo_q, hi_q = _np(mu) - 1.96 * sd, _np(mu) + 1.96 * sd
    else:
        mu, _ = m.predict(Xt, Y_metadata=Y_metadata) if Y_metadata else m.predict(Xt)
        lo_q, hi_q = _quantiles(m, Xs, lower, upper, Y_metadata)
    lib.fill_between(canvas, xs, lo_q[:, 0], hi_q[:, 0], color=tango.BLUE_LIGHT,
                     label="confidence")
    lib.plot(canvas, xs, _np(mu)[:, 0], color=tango.BLUE, lw=2, label="mean")
    if samples:
        fs = _np(m.posterior_samples_f(Xt, size=samples))
        for i in range(samples):
            lib.plot(canvas, xs, fs[:, 0, i], color=tango.BLUE, alpha=0.3, lw=0.8)
    if plot_data:
        lib.plot(canvas, _np(m.X)[:, d], _np(m.Y)[:, 0], color=tango.GREY,
                 label="data", marker="x", lw=0, mew=1.5)
    if hasattr(m, "Z"):
        plot_inducing(m, ax=canvas, visible_dims=visible_dims)
    return lib.show_canvas(canvas)


def plot_data(m, ax=None, visible_dims=None, color=tango.GREY, label="data", **kw):
    lib = _lib()
    canvas = lib.new_canvas(ax=ax)
    d = (visible_dims or [0])[0]
    lib.plot(canvas, _np(m.X)[:, d], _np(m.Y)[:, 0], color=color,
             label=label, marker="x", lw=0, mew=1.5)
    return lib.show_canvas(canvas)


def plot_data_error(m, ax=None, visible_dims=None, color=tango.GREY, **kw):
    """Error bars of the noise sd around the data (GPy data_plots.plot_errorbars)."""
    lib = _lib()
    canvas = lib.new_canvas(ax=ax)
    d = (visible_dims or [0])[0]
    sd = float(np.sqrt(_np(m.likelihood.variance))) if hasattr(m, "likelihood") else 0.0
    lib.yerrorbar(canvas, _np(m.X)[:, d], _np(m.Y)[:, 0],
                  np.full(m.X.shape[0], sd), color=color)
    return lib.show_canvas(canvas)


def plot_errorbars_trainset(m, ax=None, visible_dims=None, lower=2.5, upper=97.5, **kw):
    """Predictive quantile error bars AT the training inputs (GPy gp_plots)."""
    lib = _lib()
    canvas = lib.new_canvas(ax=ax)
    d = (visible_dims or [0])[0]
    X = _np(m.X)
    lo_q, hi_q = _quantiles(m, X, lower, upper)
    mu = _np(m.predict(_on(m, X))[0])
    err = np.stack([mu[:, 0] - lo_q[:, 0], hi_q[:, 0] - mu[:, 0]])
    lib.yerrorbar(canvas, X[:, d], mu[:, 0], err, color=tango.RED)
    return lib.show_canvas(canvas)


def plot_inducing(m, ax=None, visible_dims=None, color=tango.RED, label="inducing", **kw):
    lib = _lib()
    canvas = lib.new_canvas(ax=ax)
    d = (visible_dims or [0])[0]
    Z = _np(m.Z)
    ymin = float(_np(m.Y).min())
    lib.scatter(canvas, Z[:, d], np.full(Z.shape[0], ymin), color=color,
                label=label, marker="^")
    return lib.show_canvas(canvas)


# --- latent-space plots -------------------------------------------------------

def _latent_X(m):
    return _np(m.qX.mean) if hasattr(m, "qX") else _np(m.latent_X)


def _top_dims(m, X):
    sens = _np(m.kern.input_sensitivity())
    order = np.argsort(sens)[::-1]
    d0 = order[0]
    d1 = order[1] if X.shape[1] > 1 else order[0]
    return d0, d1


def plot_latent_scatter(m, labels=None, ax=None, **kw):
    lib = _lib()
    canvas = lib.new_canvas(ax=ax)
    X = _latent_X(m)
    d0, d1 = _top_dims(m, X)
    tango.reset()
    if labels is None:
        lib.scatter(canvas, X[:, d0], X[:, d1], color=tango.BLUE)
    else:
        labels = np.asarray(labels).reshape(-1)
        for lab in np.unique(labels):
            sel = labels == lab
            lib.scatter(canvas, X[sel, d0], X[sel, d1], color=tango.nextMedium(),
                        label=str(lab))
    try:
        canvas.set_xlabel(f"latent dim {d0}")
        canvas.set_ylabel(f"latent dim {d1}")
    except AttributeError:
        pass
    return lib.show_canvas(canvas)


def _latent_grid(X, d0, d1, resolution):
    """(lo, hi, grid): a resolution^2 grid over latent dims d0, d1 (the
    others at their mean), padded by 0.5 around the latent points."""
    lo = X[:, [d0, d1]].min(0) - 0.5
    hi = X[:, [d0, d1]].max(0) + 0.5
    G0, G1 = np.meshgrid(np.linspace(lo[0], hi[0], resolution),
                         np.linspace(lo[1], hi[1], resolution))
    Xg = np.tile(X.mean(0), (resolution * resolution, 1))
    Xg[:, d0] = G0.ravel()
    Xg[:, d1] = G1.ravel()
    return lo, hi, Xg


def plot_latent(m, labels=None, ax=None, resolution=60, plot_scatter=True, **kw):
    """Latent scatter over a greyscale background of predictive magnitude
    (GPy latent_plots.plot_latent: the background shades by the log
    predictive variance across the latent plane)."""
    lib = _lib()
    canvas = lib.new_canvas(ax=ax)
    X = _latent_X(m)
    d0, d1 = _top_dims(m, X)
    lo, hi, Xg = _latent_grid(X, d0, d1, resolution)
    _, var = m.predict(_on(m, Xg))
    V = np.log(_np(var)).mean(-1).reshape(resolution, resolution)
    lib.imshow(canvas, -V, extent=(lo[0], hi[0], lo[1], hi[1]), cmap="Greys", alpha=0.6)
    if plot_scatter:
        plot_latent_scatter(m, labels=labels, ax=canvas)
    return lib.show_canvas(canvas)


def plot_magnification(m, labels=None, ax=None, resolution=60, **kw):
    """Latent scatter over the Riemannian magnification factor
    sqrt(det(G)) of the learned mapping (GPy latent_plots.plot_magnification
    via predict_wishart_embedding)."""
    lib = _lib()
    canvas = lib.new_canvas(ax=ax)
    X = _latent_X(m)
    d0, d1 = _top_dims(m, X)
    lo, hi, Xg = _latent_grid(X, d0, d1, resolution)
    G = _np(m.predict_wishart_embedding(_on(m, Xg)))
    mag = np.sqrt(np.maximum(np.linalg.det(G), 0.0)).reshape(resolution, resolution)
    lib.imshow(canvas, mag, extent=(lo[0], hi[0], lo[1], hi[1]), cmap="Greys",
               alpha=0.7)
    plot_latent_scatter(m, labels=labels, ax=canvas)
    return lib.show_canvas(canvas)


def plot_steepest_gradient_map(m, labels=None, ax=None, resolution=60, **kw):
    """Latent map shaded by which output dimension changes fastest
    (GPy latent_plots.plot_steepest_gradient_map)."""
    lib = _lib()
    canvas = lib.new_canvas(ax=ax)
    X = _latent_X(m)
    d0, d1 = _top_dims(m, X)
    lo, hi, Xg = _latent_grid(X, d0, d1, resolution)
    J = _np(m.predict_jacobian(_on(m, Xg)))
    steep = np.argmax(np.abs(J).sum(1), axis=-1).reshape(resolution, resolution)
    lib.imshow(canvas, steep, extent=(lo[0], hi[0], lo[1], hi[1]), cmap="tab10",
               alpha=0.5)
    plot_latent_scatter(m, labels=labels, ax=canvas)
    return lib.show_canvas(canvas)


# --- kernel plots --------------------------------------------------------------

def plot_ARD(m, ax=None, color=tango.BLUE, **kw):
    lib = _lib()
    canvas = lib.new_canvas(ax=ax, xlabel="input dimension", ylabel="ARD relevance")
    sens = _np(m.kern.input_sensitivity())
    lib.bar(canvas, np.arange(len(sens)), sens, color=color)
    return lib.show_canvas(canvas)


def plot_kernel(kern, ax=None, x=None, plot_limits=(-3.0, 3.0), resolution=200,
                color=tango.BLUE, **kw):
    """k(x, x0) slice (1-D) or k over a 2-D grid. GPy: kernel_plots.plot."""
    lib = _lib()
    xs = np.linspace(*plot_limits, resolution).reshape(-1, 1)
    x0 = np.zeros((1, kern.input_dim)) if x is None else np.asarray(x).reshape(1, -1)
    if kern.input_dim >= 2:
        canvas = lib.new_canvas(ax=ax, xlabel="x0", ylabel="x1")
        r = int(np.sqrt(resolution)) * 2
        g = np.linspace(*plot_limits, r)
        G0, G1 = np.meshgrid(g, g)
        Xs = np.zeros((r * r, kern.input_dim))
        Xs[:, 0] = G0.ravel()
        Xs[:, 1] = G1.ravel()
        K = _np(kern.K(_on(kern, Xs), _on(kern, x0))).reshape(r, r)
        lib.contour(canvas, g, g, K)
        return lib.show_canvas(canvas)
    canvas = lib.new_canvas(ax=ax, xlabel="x", ylabel="k(x, x0)")
    Xs = np.tile(np.zeros(kern.input_dim), (resolution, 1))
    Xs[:, 0] = xs[:, 0]
    K = _np(kern.K(_on(kern, Xs), _on(kern, x0)))
    lib.plot(canvas, xs[:, 0], K[:, 0], color=color, lw=2)
    return lib.show_canvas(canvas)
