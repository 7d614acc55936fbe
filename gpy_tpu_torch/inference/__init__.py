"""Inference methods (public names mirror gpy_tpu.inference)."""
from .exact import ExactGaussianInference, LatentFunctionInference
from .iterative import IterativeGaussianInference, IterativePosterior
from .posterior import Posterior

__all__ = ["LatentFunctionInference", "ExactGaussianInference", "IterativeGaussianInference",
           "IterativePosterior", "Posterior"]
