"""Plotly backend (gated on plotly being installed).

Reference: GPy/plotting/plotly_dep/. The canvas is a plotly Figure.
"""
from __future__ import annotations

import numpy as np

from .abstract import AbstractPlottingLibrary

__all__ = ["PlotlyPlots"]


def _go():
    try:
        import plotly.graph_objects as go
    except ImportError as e:  # pragma: no cover - plotly not in this image
        raise ImportError(
            "the 'plotly' plotting backend requires the plotly package; "
            "install it or use change_plotting_library('matplotlib')"
        ) from e
    return go


class PlotlyPlots(AbstractPlottingLibrary):
    def new_canvas(self, figure=None, projection="2d", xlabel=None,
                   ylabel=None, title=None, ax=None, **kwargs):
        go = _go()
        fig = figure or ax or go.Figure()  # `ax` carries an existing Figure
        fig.update_layout(xaxis_title=xlabel, yaxis_title=ylabel, title=title)
        return fig

    def show_canvas(self, canvas, **kwargs):
        return canvas

    def plot(self, canvas, X, Y, color=None, label=None, **kwargs):
        go = _go()
        tr = go.Scatter(x=np.asarray(X).ravel(), y=np.asarray(Y).ravel(),
                        mode="lines", name=label, line=dict(color=color))
        canvas.add_trace(tr)
        return tr

    def scatter(self, canvas, X, Y, color=None, label=None, marker="o", **kwargs):
        go = _go()
        tr = go.Scatter(x=np.asarray(X).ravel(), y=np.asarray(Y).ravel(),
                        mode="markers", name=label, marker=dict(color=color))
        canvas.add_trace(tr)
        return tr

    def bar(self, canvas, x, height, color=None, label=None, **kwargs):
        go = _go()
        tr = go.Bar(x=np.asarray(x).ravel(), y=np.asarray(height).ravel(),
                    name=label, marker=dict(color=color))
        canvas.add_trace(tr)
        return tr

    def yerrorbar(self, canvas, X, Y, error, color=None, **kwargs):
        go = _go()
        tr = go.Scatter(x=np.asarray(X).ravel(), y=np.asarray(Y).ravel(),
                        mode="markers", error_y=dict(array=np.asarray(error).ravel()),
                        marker=dict(color=color))
        canvas.add_trace(tr)
        return tr

    xerrorbar = yerrorbar

    def imshow(self, canvas, Z, extent=None, label=None, **kwargs):
        go = _go()
        tr = go.Heatmap(z=np.asarray(Z), name=label)
        canvas.add_trace(tr)
        return tr

    def contour(self, canvas, X, Y, Z, levels=20, **kwargs):
        go = _go()
        tr = go.Contour(x=np.asarray(X).ravel(), y=np.asarray(Y).ravel(),
                        z=np.asarray(Z), ncontours=levels)
        canvas.add_trace(tr)
        return tr

    def surface(self, canvas, X, Y, Z, **kwargs):
        go = _go()
        tr = go.Surface(x=np.asarray(X), y=np.asarray(Y), z=np.asarray(Z))
        canvas.add_trace(tr)
        return tr

    def fill_between(self, canvas, X, lower, upper, color=None, label=None, **kwargs):
        go = _go()
        x = np.asarray(X).ravel()
        tr = go.Scatter(x=np.concatenate([x, x[::-1]]),
                        y=np.concatenate([np.asarray(upper).ravel(),
                                          np.asarray(lower).ravel()[::-1]]),
                        fill="toself", name=label, line=dict(width=0),
                        fillcolor=color, opacity=0.3)
        canvas.add_trace(tr)
        return tr

    def fill_gradient(self, canvas, X, percentiles, color=None, label=None, **kwargs):
        artists = []
        n = len(percentiles) // 2
        for i in range(n):
            artists.append(self.fill_between(canvas, X, percentiles[i],
                                             percentiles[-(i + 1)], color=color,
                                             label=label if i == 0 else None))
        return artists

    def annotation_heatmap(self, canvas, Z, annotation, extent=None, label=None, **kwargs):
        return self.imshow(canvas, Z, extent=extent, label=label)
