"""Models (public names mirror gpy_tpu.models)."""
from ..core.svgp import SVGP
from .gp_coregionalized_regression import GPHeteroscedasticRegression
from .gp_regression import GPRegression
from .sparse_gp_regression import SparseGPRegression, SparseGPRegressionMD

__all__ = ["GPRegression", "GPHeteroscedasticRegression", "SparseGPRegression",
           "SparseGPRegressionMD", "SVGP"]
