"""Likelihoods (public names mirror gpy_tpu.likelihoods)."""
from . import link_functions
from .bernoulli import Bernoulli
from .families import (Binomial, Exponential, Gamma, LogGaussian, LogLogistic, Poisson, StudentT,
                       Weibull)
from .gaussian import Gaussian, HeteroscedasticGaussian
from .likelihood import Likelihood
from .mixed_noise import MixedNoise, MultioutputLikelihood
from .symbolic import SymbolicLikelihood

__all__ = ["link_functions", "Likelihood", "Gaussian", "HeteroscedasticGaussian", "Bernoulli",
           "Poisson", "Binomial", "Exponential", "Gamma", "StudentT", "Weibull", "LogLogistic",
           "LogGaussian", "MixedNoise", "MultioutputLikelihood", "SymbolicLikelihood"]
