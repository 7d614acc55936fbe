"""Covariance functions (public names mirror gpy_tpu.kern)."""
from .basis_funcs import (BasisFuncKernel, ChangePointBasisFuncKernel, DomainKernel,
                          LinearSlopeBasisFuncKernel, LogisticBasisFuncKernel,
                          PolynomialBasisFuncKernel)
from .coregionalize import Coregionalize, Hierarchical, IndependentOutputs
from .eq_ode1 import EQ_ODE1
from .eq_ode2 import EQ_ODE2
from .integral import Integral, Integral_Limits, Multidimensional_Integral_Limits
from .kern import Add, CombinationKernel, Kern, Prod
from .linear import Linear, LinearFull, TruncLinear, TruncLinear_inf
from .misc import MLP, Brownian, Poly, Spline
from .multioutput_kern import DiffKern, MultioutputDerivativeKern, MultioutputKern
from .ode_uy import ODE_UY, ODE_UYC, ODE_st, ODE_t
from .periodic import PeriodicExponential, PeriodicMatern32, PeriodicMatern52, StdPeriodic
from .symbolic import Symbolic
from .symmetric import DEtime, GridRBF, SplitKern, Symmetric
from .static import Bias, Fixed, Precomputed, Static, White, WhiteHeteroscedastic
from .stationary import (OU, RBF, Cosine, Exponential, ExpQuad, ExpQuadCosine, Matern32,
                         Matern52, RatQuad, Sinc, Stationary)
from . import sde  # noqa: E402,F401  (attaches sde() to RBF, RatQuad, StdPeriodic, ...)

# The reference's sde_* names are the kernels themselves
# (gpy_tpu/kern/__init__.py:39-53): every kernel with a state-space form
# carries sde(), and White folds into the observation noise
# (models/state_space.py).
sde_Matern32 = Matern32
sde_Matern52 = Matern52
sde_Exponential = Exponential
sde_RBF = RBF
sde_RatQuad = RatQuad
sde_StdPeriodic = StdPeriodic
sde_Linear = Linear
sde_White = White
sde_Bias = Bias
sde_Brownian = Brownian

# GPy kern/__init__.py:59: DiffGenomeKern is the DEtime split kernel
DiffGenomeKern = DEtime

__all__ = ["Kern", "CombinationKernel", "Add", "Prod", "Stationary", "RBF", "ExpQuad",
           "Exponential", "OU", "Matern32", "Matern52", "Cosine", "ExpQuadCosine", "Sinc",
           "RatQuad", "Static", "White", "Bias", "Fixed", "WhiteHeteroscedastic", "Precomputed",
           "Linear", "LinearFull", "TruncLinear", "TruncLinear_inf", "Coregionalize",
           "IndependentOutputs", "Hierarchical", "MultioutputKern", "MultioutputDerivativeKern",
           "DiffKern", "StdPeriodic", "PeriodicExponential", "PeriodicMatern32",
           "PeriodicMatern52", "MLP", "Poly", "Brownian", "Spline", "sde_Matern32",
           "sde_Matern52", "sde_Exponential", "sde_RBF", "sde_RatQuad", "sde_StdPeriodic",
           "sde_Linear", "sde_White", "sde_Bias", "sde_Brownian", "BasisFuncKernel",
           "PolynomialBasisFuncKernel", "LinearSlopeBasisFuncKernel", "ChangePointBasisFuncKernel",
           "DomainKernel", "LogisticBasisFuncKernel", "Integral", "Integral_Limits",
           "Multidimensional_Integral_Limits", "Symmetric", "SplitKern", "DEtime", "GridRBF",
           "DiffGenomeKern", "EQ_ODE1", "EQ_ODE2", "ODE_UY", "ODE_UYC", "ODE_st",
           "ODE_t", "Symbolic"]
