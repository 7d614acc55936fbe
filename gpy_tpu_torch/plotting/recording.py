"""Recording backend: captures the ARRAYS behind every plot primitive.

The data-level golden-test harness (reference: GPy/testing/test_plotting.py
compares plot *contents* against testing/baseline/*.npz, not pixels). Also a
user-facing way to extract plot data without a display:

    gpy_tpu_torch.plotting.change_plotting_library("recording")
    calls = m.plot()          # -> RecordingCanvas: list of (primitive, kwargs)
    calls.arrays("plot")      # -> [ {"X": ..., "Y": ...}, ... ]
"""
from __future__ import annotations

import numpy as np

from .abstract import AbstractPlottingLibrary

__all__ = ["RecordingPlots", "RecordingCanvas"]


class RecordingCanvas(list):
    """List of (primitive_name, dict) entries; arrays stored as np.ndarray."""

    def arrays(self, primitive=None):
        """All recorded array-dicts, optionally filtered by primitive name."""
        return [d for name, d in self if primitive is None or name == primitive]

    def primitives(self):
        return [name for name, _ in self]

    # composed helpers call canvas.set_xlabel etc.
    def set_xlabel(self, *_a, **_k):
        pass

    def set_ylabel(self, *_a, **_k):
        pass


def _rec(canvas, name, **entries):
    canvas.append((name, {k: (np.asarray(v) if hasattr(v, "__len__") or hasattr(v, "shape") else v)
                          for k, v in entries.items() if v is not None}))
    return canvas


class RecordingPlots(AbstractPlottingLibrary):
    def new_canvas(self, figure=None, projection="2d", xlabel=None, ylabel=None,
                   zlabel=None, title=None, ax=None, **kwargs):
        if isinstance(ax, RecordingCanvas):
            return ax  # composed plots draw onto the same canvas
        return RecordingCanvas()

    def show_canvas(self, canvas, **kwargs):
        return canvas

    def plot(self, canvas, X, Y, color=None, label=None, **kw):
        return _rec(canvas, "plot", X=X, Y=Y, label=label)

    def scatter(self, canvas, X, Y, color=None, label=None, marker="o", **kw):
        return _rec(canvas, "scatter", X=X, Y=Y, label=label)

    def bar(self, canvas, x, height, color=None, label=None, **kw):
        return _rec(canvas, "bar", x=x, height=height, label=label)

    def xerrorbar(self, canvas, X, Y, error, color=None, **kw):
        return _rec(canvas, "xerrorbar", X=X, Y=Y, error=error)

    def yerrorbar(self, canvas, X, Y, error, color=None, **kw):
        return _rec(canvas, "yerrorbar", X=X, Y=Y, error=error)

    def imshow(self, canvas, Z, extent=None, label=None, **kw):
        return _rec(canvas, "imshow", Z=Z, extent=extent, label=label)

    def contour(self, canvas, X, Y, Z, levels=20, **kw):
        return _rec(canvas, "contour", X=X, Y=Y, Z=Z)

    def surface(self, canvas, X, Y, Z, **kw):
        return _rec(canvas, "surface", X=X, Y=Y, Z=Z)

    def fill_between(self, canvas, X, lower, upper, color=None, label=None, **kw):
        return _rec(canvas, "fill_between", X=X, lower=lower, upper=upper, label=label)

    def fill_gradient(self, canvas, X, percentiles, color=None, label=None, **kw):
        return _rec(canvas, "fill_gradient", X=X,
                    percentiles=np.asarray(percentiles), label=label)

    def annotation_heatmap(self, canvas, Z, annotation, extent=None, label=None, **kw):
        return _rec(canvas, "annotation_heatmap", Z=Z, extent=extent)
