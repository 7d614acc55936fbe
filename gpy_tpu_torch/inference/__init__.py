"""Inference methods (public names mirror gpy_tpu.inference)."""
from .ep import EP
from .epdtc import EPDTC
from .exact import ExactGaussianInference, LatentFunctionInference
from .fitc import DTC, FITC, PEP
from .iterative import IterativeGaussianInference, IterativePosterior
from .laplace import Laplace, LaplaceBlock
from .posterior import Posterior
from .svgp import SVGPInference
from .var_dtc import VarDTC, VarDTC_minibatch
from .var_dtc_missing import VarDTCMissingData

__all__ = ["LatentFunctionInference", "ExactGaussianInference", "IterativeGaussianInference",
           "IterativePosterior", "Posterior", "VarDTC", "VarDTC_minibatch", "VarDTCMissingData",
           "FITC", "DTC", "PEP", "SVGPInference", "Laplace", "LaplaceBlock", "EP", "EPDTC"]
