"""Abstract plotting backend interface.

Reference: GPy/plotting/abstract_plotting_library.py:34
(AbstractPlottingLibrary — every backend implements the same primitive set
so model-plot logic in gpy_plot.py is backend-agnostic).
"""
from __future__ import annotations

__all__ = ["AbstractPlottingLibrary"]


class AbstractPlottingLibrary:
    """Primitive drawing operations a backend must provide.

    A "canvas" is whatever the backend draws on (a matplotlib Axes, a
    plotly Figure). Every primitive returns the created artist(s) so
    callers can build GPy-style plot dictionaries.
    """

    def new_canvas(self, figure=None, projection="2d", xlabel=None,
                   ylabel=None, title=None, **kwargs):
        raise NotImplementedError

    def show_canvas(self, canvas, **kwargs):
        raise NotImplementedError

    def plot(self, canvas, X, Y, color=None, label=None, **kwargs):
        raise NotImplementedError

    def scatter(self, canvas, X, Y, color=None, label=None, marker="o", **kwargs):
        raise NotImplementedError

    def bar(self, canvas, x, height, color=None, label=None, **kwargs):
        raise NotImplementedError

    def xerrorbar(self, canvas, X, Y, error, color=None, **kwargs):
        raise NotImplementedError

    def yerrorbar(self, canvas, X, Y, error, color=None, **kwargs):
        raise NotImplementedError

    def imshow(self, canvas, Z, extent=None, label=None, **kwargs):
        raise NotImplementedError

    def contour(self, canvas, X, Y, Z, levels=20, **kwargs):
        raise NotImplementedError

    def surface(self, canvas, X, Y, Z, **kwargs):
        raise NotImplementedError

    def fill_between(self, canvas, X, lower, upper, color=None, label=None, **kwargs):
        raise NotImplementedError

    def fill_gradient(self, canvas, X, percentiles, color=None, label=None, **kwargs):
        """Nested translucent bands for a ladder of percentiles."""
        raise NotImplementedError

    def annotation_heatmap(self, canvas, Z, annotation, extent=None, label=None, **kwargs):
        raise NotImplementedError
