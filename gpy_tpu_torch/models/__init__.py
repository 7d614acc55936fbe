"""Models (public names mirror gpy_tpu.models)."""
from ..core.svgp import SVGP
from .gp_regression import GPRegression
from .sparse_gp_regression import SparseGPRegression

__all__ = ["GPRegression", "SparseGPRegression", "SVGP"]
