"""Inference methods (public names mirror gpy_tpu.inference)."""
from .exact import ExactGaussianInference, LatentFunctionInference
from .iterative import IterativeGaussianInference, IterativePosterior
from .posterior import Posterior
from .svgp import SVGPInference
from .var_dtc import VarDTC

__all__ = ["LatentFunctionInference", "ExactGaussianInference", "IterativeGaussianInference",
           "IterativePosterior", "Posterior", "VarDTC", "SVGPInference"]
