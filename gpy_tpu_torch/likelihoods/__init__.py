"""Likelihoods (public names mirror gpy_tpu.likelihoods)."""
from . import link_functions
from .gaussian import Gaussian, HeteroscedasticGaussian
from .likelihood import Likelihood

__all__ = ["link_functions", "Likelihood", "Gaussian", "HeteroscedasticGaussian"]
