"""Models (public names mirror gpy_tpu.models)."""
from ..core.svgp import SVGP
from .gp_classification import GPClassification, GPClassificationLaplace
from .gp_coregionalized_regression import (GPCoregionalizedRegression, GPHeteroscedasticRegression,
                                          GPOffsetRegression, SparseGPCoregionalizedRegression)
from .gp_regression import GPRegression
from .multioutput_gp import MultioutputGP
from .one_vs_all_classification import OneVsAllClassification, OneVsAllSparseClassification
# SparseGPClassificationUncertainInput stays in its module until A12 brings
# uncertain inputs: it raises there
from .sparse_gp_classification import SparseGPClassification
from .sparse_gp_regression import SparseGPRegression, SparseGPRegressionMD

__all__ = ["GPRegression", "GPHeteroscedasticRegression", "SparseGPRegression",
           "SparseGPRegressionMD", "SVGP", "GPClassification", "GPClassificationLaplace",
           "SparseGPClassification",
           "OneVsAllClassification", "OneVsAllSparseClassification",
           "GPCoregionalizedRegression", "SparseGPCoregionalizedRegression", "GPOffsetRegression",
           "MultioutputGP"]
