"""Covariance functions (public names mirror gpy_tpu.kern)."""
from .coregionalize import Coregionalize, Hierarchical, IndependentOutputs
from .kern import Add, CombinationKernel, Kern, Prod
from .linear import Linear, LinearFull, TruncLinear, TruncLinear_inf
from .multioutput_kern import DiffKern, MultioutputDerivativeKern, MultioutputKern
from .static import Bias, Fixed, Precomputed, Static, White, WhiteHeteroscedastic
from .stationary import (OU, RBF, Cosine, Exponential, ExpQuad, ExpQuadCosine, Matern32,
                         Matern52, RatQuad, Sinc, Stationary)

__all__ = ["Kern", "CombinationKernel", "Add", "Prod", "Stationary", "RBF", "ExpQuad",
           "Exponential", "OU", "Matern32", "Matern52", "Cosine", "ExpQuadCosine", "Sinc",
           "RatQuad", "Static", "White", "Bias", "Fixed", "WhiteHeteroscedastic", "Precomputed",
           "Linear", "LinearFull", "TruncLinear", "TruncLinear_inf", "Coregionalize",
           "IndependentOutputs", "Hierarchical", "MultioutputKern", "MultioutputDerivativeKern",
           "DiffKern"]
