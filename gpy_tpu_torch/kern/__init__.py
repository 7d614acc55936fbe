"""Covariance functions (public names mirror gpy_tpu.kern)."""
from .kern import Add, CombinationKernel, Kern, Prod
from .linear import Linear, LinearFull, TruncLinear, TruncLinear_inf
from .static import Bias, Fixed, Precomputed, Static, White, WhiteHeteroscedastic
from .stationary import (OU, RBF, Cosine, Exponential, ExpQuad, ExpQuadCosine, Matern32,
                         Matern52, RatQuad, Sinc, Stationary)

__all__ = ["Kern", "CombinationKernel", "Add", "Prod", "Stationary", "RBF", "ExpQuad",
           "Exponential", "OU", "Matern32", "Matern52", "Cosine", "ExpQuadCosine", "Sinc",
           "RatQuad", "Static", "White", "Bias", "Fixed", "WhiteHeteroscedastic", "Precomputed",
           "Linear", "LinearFull", "TruncLinear", "TruncLinear_inf"]
