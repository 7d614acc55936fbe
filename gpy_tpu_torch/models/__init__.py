"""Models (public names mirror gpy_tpu.models)."""
from ..core.svgp import SVGP
from .gp_classification import GPClassification, GPClassificationLaplace
from .gp_coregionalized_regression import (GPCoregionalizedRegression, GPHeteroscedasticRegression,
                                          GPOffsetRegression, SparseGPCoregionalizedRegression)
from .gp_kronecker_gaussian_regression import GPKroneckerGaussianRegression, GPRegressionGrid
from .gp_multiout_regression import GPMultioutRegression, GPMultioutRegressionMD
from .gp_regression import GPRegression
from .gp_var_gauss import GPVariationalGaussianApproximation
from .gradient_checker import GradientChecker, HessianChecker, SkewChecker
from .gplvm import BCGPLVM, GPLVM, MRD, BayesianGPLVM, DPBayesianGPLVM, SparseGPLVM
from .ibp_lfm import IBPLFM
from .multioutput_gp import MultioutputGP
from .one_vs_all_classification import OneVsAllClassification, OneVsAllSparseClassification
from .sparse_gp_classification import (SparseGPClassification,
                                       SparseGPClassificationUncertainInput)
from .sparse_gp_minibatch import BayesianGPLVMMiniBatch, SparseGPMiniBatch
from .sparse_gp_regression import SparseGPRegression, SparseGPRegressionMD
from .ss_gplvm import SSGPLVM, SSMRD
from .state_space import StateSpace
from .tp_regression import TPRegression
from .warped_gp import InputWarpedGP, WarpedGP

__all__ = ["GPRegression", "GPHeteroscedasticRegression", "SparseGPRegression",
           "SparseGPRegressionMD", "SVGP", "GPClassification", "GPClassificationLaplace",
           "SparseGPClassification",
           "OneVsAllClassification", "OneVsAllSparseClassification",
           "GPCoregionalizedRegression", "SparseGPCoregionalizedRegression", "GPOffsetRegression",
           "MultioutputGP", "SparseGPClassificationUncertainInput", "GPLVM", "SparseGPLVM",
           "BayesianGPLVM", "BayesianGPLVMMiniBatch", "SparseGPMiniBatch", "MRD", "SSGPLVM",
           "SSMRD", "BCGPLVM", "DPBayesianGPLVM", "GPMultioutRegression",
           "GPMultioutRegressionMD", "TPRegression", "StateSpace", "WarpedGP", "InputWarpedGP",
           "GPKroneckerGaussianRegression", "GPRegressionGrid",
           "GPVariationalGaussianApproximation", "GradientChecker", "HessianChecker",
           "SkewChecker", "IBPLFM"]
