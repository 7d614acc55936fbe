"""Specialty matplotlib plots + lightweight interactive controllers.

Reference: GPy/plotting/matplot_dep/{priors_plots.py, variational_plots.py,
img_plots.py, maps.py, controllers/axis_event_controller.py:AxisChangedController,
controllers/imshow_controller.py:ImshowController}.

Counterpart of gpy_tpu/plotting/dep_plots.py: drawing is host-only, so
model values come to the host as numpy first. maps.py needs the optional
`shapefile` (pyshp) package, gated with a clean error.
"""
from __future__ import annotations

import numpy as np
import torch

from ..util.misc import param_to_array as _np

__all__ = [
    "plot_prior", "univariate_plot",
    "plot_variational_dist",
    "plot_2D_images",
    "plot_bbox", "string_match",  # maps.py surface (gated)
    "AxisChangedController", "ImshowController",
]


def _plt():
    import matplotlib.pyplot as plt

    return plt


# --- priors_plots.py ---------------------------------------------------------
def univariate_plot(prior, xlim=None, n=400, ax=None):
    """Plot a univariate prior density over a sensible range.

    GPy: matplot_dep/priors_plots.py (univariate_plot / plot).
    """
    plt = _plt()
    if ax is None:
        _, ax = plt.subplots()
    if xlim is None:
        try:
            s = np.asarray(prior.rvs(1000))
            lo, hi = np.percentile(s, [0.5, 99.5])
            pad = 0.1 * (hi - lo) + 1e-6
            xlim = (lo - pad, hi + pad)
        except NotImplementedError:  # a prior without a sampler
            xlim = (-5.0, 5.0)
    x = np.linspace(xlim[0], xlim[1], n)
    y = _np(torch.exp(prior.lnpdf(torch.tensor(x, dtype=torch.float64))))
    ax.plot(x, y, lw=2)
    ax.set_title(getattr(prior, "name", type(prior).__name__))
    return ax


plot_prior = univariate_plot


# --- variational_plots.py ----------------------------------------------------
def plot_variational_dist(qX, colors=None, ax=None):
    """Plot q(X) means per latent dimension with +-2 sd bands.

    GPy: matplot_dep/variational_plots.py (plot). qX: NormalPosterior-like
    with .mean (N, Q) and .variance (N, Q).
    """
    plt = _plt()
    if ax is None:
        _, ax = plt.subplots()
    mu = _np(qX.mean)
    sd = np.sqrt(_np(qX.variance))
    idx = np.arange(mu.shape[0])
    for q in range(mu.shape[1]):
        c = None if colors is None else colors[q % len(colors)]
        (line,) = ax.plot(idx, mu[:, q], label=f"dim {q}", color=c)
        ax.fill_between(idx, mu[:, q] - 2 * sd[:, q], mu[:, q] + 2 * sd[:, q],
                        alpha=0.2, color=line.get_color())
    ax.legend(loc="best")
    return ax


# --- img_plots.py ------------------------------------------------------------
def plot_2D_images(figure_or_axes, Y, imgsize, layout=None, cmap="gray"):
    """Tile rows of Y as imgsize images in a grid (GPy: img_plots.py)."""
    plt = _plt()
    Y = _np(Y)
    n = Y.shape[0]
    if layout is None:
        cols = int(np.ceil(np.sqrt(n)))
        layout = (int(np.ceil(n / cols)), cols)
    fig = figure_or_axes if hasattr(figure_or_axes, "add_subplot") else plt.figure()
    axes = []
    for i in range(n):
        ax = fig.add_subplot(layout[0], layout[1], i + 1)
        ax.imshow(Y[i].reshape(imgsize), cmap=cmap)
        ax.set_xticks([])
        ax.set_yticks([])
        axes.append(ax)
    return axes


# --- maps.py (gated on pyshp) -----------------------------------------------
def _shapefile():
    try:
        import shapefile

        return shapefile
    except ImportError as e:
        raise ImportError(
            "map plotting needs the optional 'pyshp' package (import "
            "shapefile); it is not installed in this environment. The "
            "reference's maps.py (GPy/plotting/matplot_dep/maps.py) has the "
            "same dependency."
        ) from e


def plot_bbox(sf_path, bbox=None, ax=None, facecolor="none", edgecolor="k"):
    """Plot shapefile records intersecting bbox. GPy: maps.py:plot_bbox."""
    shapefile = _shapefile()
    plt = _plt()
    if ax is None:
        _, ax = plt.subplots()
    sf = shapefile.Reader(sf_path)
    from matplotlib.patches import Polygon

    for shape in sf.shapes():
        if bbox is not None:
            sb = shape.bbox
            if sb[2] < bbox[0] or sb[0] > bbox[2] or sb[3] < bbox[1] or sb[1] > bbox[3]:
                continue
        ax.add_patch(Polygon(np.asarray(shape.points), closed=True,
                             facecolor=facecolor, edgecolor=edgecolor))
    ax.autoscale_view()
    return ax


def string_match(sf_path, field, regex):
    """Indices of shapefile records whose `field` matches regex.
    GPy: maps.py:string_match."""
    import re

    shapefile = _shapefile()
    sf = shapefile.Reader(sf_path)
    fields = [f[0] for f in sf.fields[1:]]
    col = fields.index(field)
    return [i for i, rec in enumerate(sf.records()) if re.search(regex, str(rec[col]))]


# --- controllers -------------------------------------------------------------
class AxisChangedController:
    """Re-render a view when the axis limits change (pan/zoom).

    GPy: controllers/axis_event_controller.py:AxisChangedController —
    callbacks on xlim/ylim changed events with an update resolution.
    """

    def __init__(self, ax, update_lim: float = 0.9):
        self.ax = ax
        self.update_lim = update_lim
        self._xlim = tuple(ax.get_xlim())
        self._ylim = tuple(ax.get_ylim())
        ax.callbacks.connect("xlim_changed", self._on_change)
        ax.callbacks.connect("ylim_changed", self._on_change)

    def _moved_enough(self, old, new):
        span = abs(old[1] - old[0]) + 1e-12
        return (abs(new[0] - old[0]) + abs(new[1] - old[1])) / span > (1 - self.update_lim)

    def _on_change(self, ax):
        xl, yl = tuple(ax.get_xlim()), tuple(ax.get_ylim())
        if self._moved_enough(self._xlim, xl) or self._moved_enough(self._ylim, yl):
            self._xlim, self._ylim = xl, yl
            self.update_view(ax)

    def update_view(self, ax):  # subclasses override
        pass


class ImshowController(AxisChangedController):
    """imshow whose content recomputes for the visible extent.

    GPy: controllers/imshow_controller.py:ImshowController —
    `plot_function(x_min, x_max, y_min, y_max, resolution)` -> image array.
    """

    def __init__(self, ax, plot_function, plot_limits, resolution=50, **imshow_kw):
        self.plot_function = plot_function
        self.resolution = resolution
        x0, y0, x1, y1 = plot_limits
        img = np.asarray(plot_function(x0, x1, y0, y1, resolution))
        self.view = ax.imshow(img, extent=(x0, x1, y0, y1), origin="lower",
                              aspect="auto", **imshow_kw)
        super().__init__(ax)

    def update_view(self, ax):
        (x0, x1), (y0, y1) = ax.get_xlim(), ax.get_ylim()
        img = np.asarray(self.plot_function(x0, x1, y0, y1, self.resolution))
        self.view.set_data(img)
        self.view.set_extent((x0, x1, y0, y1))
        if ax.figure.canvas is not None:
            ax.figure.canvas.draw_idle()
