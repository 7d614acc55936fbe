"""Runnable demos, one module per family: the counterpart of
gpy_tpu/examples (GPy/examples). Each function builds, optionally
optimizes and returns its model on `device` ("cuda" unless the caller
passes "cpu") and `dtype`; plot=True draws through gpy_tpu_torch.plotting."""
from .. import plotting  # noqa: F401  (attaches m.plot and the other plot methods)
from . import advanced, classification, dimensionality_reduction, non_gaussian, regression
from . import state_space

__all__ = ["advanced", "regression", "classification", "dimensionality_reduction",
           "non_gaussian", "state_space"]
