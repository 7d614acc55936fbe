"""Plotting subsystem: backend registry + model-method injection.

Counterpart of gpy_tpu/plotting/__init__.py (GPy/plotting/__init__.py:
change_plotting_library:25-55, injection of m.plot_* methods :59-130).
Backends implement `abstract.AbstractPlottingLibrary`; 'matplotlib' is
the default, 'plotly' works where the plotly package is installed,
'recording' keeps the arrays behind every primitive, 'none' disables
plotting. The backend can also be chosen with the GPY_TPU_TORCH_PLOTTING
environment variable. matplotlib and plotly are imported when a plot is
drawn, not here: importing this package needs neither.
"""
from __future__ import annotations

import os

from . import tango  # noqa: F401
from . import dep_plots  # noqa: F401
from .gpy_plot import (  # noqa: F401
    plot_ARD,
    plot_confidence,
    plot_data,
    plot_data_error,
    plot_density,
    plot_errorbars_trainset,
    plot_fit,
    plot_inducing,
    plot_kernel,
    plot_latent,
    plot_latent_scatter,
    plot_magnification,
    plot_mean,
    plot_samples,
    plot_steepest_gradient_map,
)

__all__ = [
    "change_plotting_library", "plotting_library", "attach_plotting",
    "plot_fit", "plot_mean", "plot_confidence", "plot_density", "plot_samples",
    "plot_data", "plot_data_error", "plot_errorbars_trainset", "plot_inducing",
    "plot_latent", "plot_latent_scatter", "plot_magnification",
    "plot_steepest_gradient_map", "plot_ARD", "plot_kernel", "tango",
]

_library = [None]
_library_name = [None]


def change_plotting_library(name):
    """Select the plotting backend: 'matplotlib' | 'plotly' | 'none'.

    GPy: plotting/__init__.py change_plotting_library."""
    if name == "matplotlib":
        from .matplot import MatplotlibPlots

        _library[0] = MatplotlibPlots()
    elif name == "plotly":
        from .plotly_backend import PlotlyPlots

        _library[0] = PlotlyPlots()
    elif name == "recording":
        from .recording import RecordingPlots

        _library[0] = RecordingPlots()
    elif name == "none":
        _library[0] = None
    else:
        raise ValueError(
            f"unknown plotting library {name!r}; choose 'matplotlib', 'plotly', "
            "'recording' or 'none'")
    _library_name[0] = name


def plotting_library():
    if _library[0] is None:
        raise RuntimeError(
            "no plotting library active — call "
            "gpy_tpu_torch.plotting.change_plotting_library('matplotlib')")
    return _library[0]


change_plotting_library(os.environ.get("GPY_TPU_TORCH_PLOTTING", "matplotlib"))


def attach_plotting():
    """Inject plot methods onto model classes (GPy plotting/__init__.py:59-130)."""
    from ..core.gp import GP
    from ..core.model import Model
    from ..kern.kern import Kern
    from ..models.gplvm import GPLVM, BayesianGPLVM

    GP.plot = plot_fit
    GP.plot_f = lambda m, **kw: plot_fit(m, plot_raw=True, **kw)
    GP.plot_mean = plot_mean
    GP.plot_confidence = plot_confidence
    GP.plot_density = plot_density
    GP.plot_samples = plot_samples
    GP.plot_data = plot_data
    GP.plot_data_error = plot_data_error
    GP.plot_errorbars_trainset = plot_errorbars_trainset
    GP.plot_ARD = plot_ARD
    Model.plot_ARD = plot_ARD
    Kern.plot = plot_kernel
    Kern.plot_ARD = plot_ARD
    for cls in (GPLVM, BayesianGPLVM):
        cls.plot_latent = plot_latent
        cls.plot_latent_scatter = plot_latent_scatter
        cls.plot_magnification = plot_magnification
        cls.plot_steepest_gradient_map = plot_steepest_gradient_map


attach_plotting()
