"""Covariance functions (public names mirror gpy_tpu.kern)."""
from .kern import Add, CombinationKernel, Kern, Prod
from .static import Bias, Static, White
from .stationary import OU, RBF, Exponential, ExpQuad, Matern32, Matern52, Stationary

__all__ = ["Kern", "CombinationKernel", "Add", "Prod", "Stationary", "RBF", "ExpQuad", "Exponential", "OU", "Matern32", "Matern52", "Static", "White", "Bias"]
