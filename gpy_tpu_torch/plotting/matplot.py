"""Matplotlib backend. Reference: GPy/plotting/matplot_dep/plot_definitions.py."""
from __future__ import annotations

import numpy as np

from .abstract import AbstractPlottingLibrary

__all__ = ["MatplotlibPlots"]


class MatplotlibPlots(AbstractPlottingLibrary):
    def _plt(self):
        import matplotlib.pyplot as plt

        return plt

    def new_canvas(self, figure=None, projection="2d", xlabel=None,
                   ylabel=None, title=None, figsize=None, ax=None, **kwargs):
        plt = self._plt()
        if ax is None:
            if projection == "3d":
                fig = figure or plt.figure(figsize=figsize)
                ax = fig.add_subplot(111, projection="3d")
            else:
                _, ax = plt.subplots(figsize=figsize)
        if xlabel:
            ax.set_xlabel(xlabel)
        if ylabel:
            ax.set_ylabel(ylabel)
        if title:
            ax.set_title(title)
        return ax

    def show_canvas(self, canvas, legend=True, **kwargs):
        if legend:
            handles, labels = canvas.get_legend_handles_labels()
            if labels:
                canvas.legend(loc="best")
        return canvas

    def plot(self, canvas, X, Y, color=None, label=None, **kwargs):
        return canvas.plot(np.asarray(X), np.asarray(Y), color=color, label=label, **kwargs)

    def scatter(self, canvas, X, Y, color=None, label=None, marker="o", **kwargs):
        return canvas.scatter(np.asarray(X), np.asarray(Y), c=color, label=label,
                              marker=marker, **kwargs)

    def bar(self, canvas, x, height, color=None, label=None, **kwargs):
        return canvas.bar(np.asarray(x), np.asarray(height), color=color, label=label, **kwargs)

    def xerrorbar(self, canvas, X, Y, error, color=None, **kwargs):
        return canvas.errorbar(np.asarray(X), np.asarray(Y), xerr=np.asarray(error),
                               ecolor=color, fmt="none", **kwargs)

    def yerrorbar(self, canvas, X, Y, error, color=None, **kwargs):
        return canvas.errorbar(np.asarray(X), np.asarray(Y), yerr=np.asarray(error),
                               ecolor=color, fmt="none", **kwargs)

    def imshow(self, canvas, Z, extent=None, label=None, **kwargs):
        kwargs.setdefault("origin", "lower")
        kwargs.setdefault("aspect", "auto")
        return canvas.imshow(np.asarray(Z), extent=extent, **kwargs)

    def contour(self, canvas, X, Y, Z, levels=20, **kwargs):
        return canvas.contour(np.asarray(X), np.asarray(Y), np.asarray(Z),
                              levels=levels, **kwargs)

    def surface(self, canvas, X, Y, Z, **kwargs):
        return canvas.plot_surface(np.asarray(X), np.asarray(Y), np.asarray(Z), **kwargs)

    def fill_between(self, canvas, X, lower, upper, color=None, label=None, alpha=0.3, **kwargs):
        return canvas.fill_between(np.asarray(X).ravel(), np.asarray(lower).ravel(),
                                   np.asarray(upper).ravel(), color=color, label=label,
                                   alpha=alpha, lw=0, **kwargs)

    def fill_gradient(self, canvas, X, percentiles, color=None, label=None, **kwargs):
        artists = []
        n = len(percentiles) // 2
        for i in range(n):
            lo, hi = percentiles[i], percentiles[-(i + 1)]
            artists.append(self.fill_between(
                canvas, X, lo, hi, color=color, alpha=0.5 / n,
                label=label if i == 0 else None, **kwargs))
        return artists

    def annotation_heatmap(self, canvas, Z, annotation, extent=None, label=None, **kwargs):
        im = self.imshow(canvas, Z, extent=extent, **kwargs)
        Z = np.asarray(Z)
        for (i, j), txt in np.ndenumerate(np.asarray(annotation)):
            canvas.text(j, i, str(txt), ha="center", va="center", fontsize=8)
        return im
