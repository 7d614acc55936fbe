"""Inference methods (public names mirror gpy_tpu.inference)."""
from .ep import EP
from .epdtc import EPDTC
from .exact import ExactGaussianInference, ExactStudentTInference, LatentFunctionInference
from .fitc import DTC, FITC, PEP
from .grid import GaussianGridInference
from .iterative import IterativeGaussianInference, IterativePosterior
from .laplace import Laplace, LaplaceBlock
from .posterior import Posterior
from .svgp import SVGPInference
from .svi_multiout import PosteriorMultioutput, VarDTC_SVI_Multiout, VarDTC_SVI_Multiout_Miss
from .var_dtc import VarDTC, VarDTC_minibatch
from .var_dtc_missing import VarDTCMissingData
from .var_gauss import VarGauss

__all__ = ["LatentFunctionInference", "ExactGaussianInference", "IterativeGaussianInference",
           "IterativePosterior", "Posterior", "VarDTC", "VarDTC_minibatch", "VarDTCMissingData",
           "FITC", "DTC", "PEP", "SVGPInference", "Laplace", "LaplaceBlock", "EP", "EPDTC",
           "ExactStudentTInference", "VarDTC_SVI_Multiout", "VarDTC_SVI_Multiout_Miss",
           "PosteriorMultioutput", "VarGauss", "GaussianGridInference"]
