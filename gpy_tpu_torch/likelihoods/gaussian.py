"""Gaussian likelihoods (closed forms everywhere).

Counterpart of gpy_tpu/likelihoods/gaussian.py:18-114 (GPy/likelihoods/
gaussian.py): Gaussian, and HeteroscedasticGaussian with one variance per
data point.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from scipy.stats import norm

from ..core.transformations import Logexp
from .likelihood import Likelihood
from .link_functions import Identity

__all__ = ["Gaussian", "HeteroscedasticGaussian"]


class Gaussian(Likelihood):
    log_concave = True

    def __init__(self, gp_link=None, variance=1.0, name="Gaussian_noise", device=None, dtype=None):
        super().__init__(gp_link or Identity(), name=name, device=device, dtype=dtype)
        self._add_param("variance", variance, transform=Logexp())

    def gaussian_variance(self, Y_metadata=None) -> torch.Tensor:
        return self.variance.values

    def logpdf_link(self, link_f, y, Y_metadata=None):
        s2 = self.gaussian_variance(Y_metadata)
        return -0.5 * torch.log(2 * math.pi * s2) - 0.5 * (y - link_f) ** 2 / s2

    def variational_expectations(self, Y, m, v, Y_metadata=None):
        """Closed form E_q[log N(y; f, s2)]."""
        s2 = self.gaussian_variance(Y_metadata)
        return -0.5 * torch.log(2 * math.pi * s2) - 0.5 * ((Y - m) ** 2 + v) / s2

    def predictive_values(self, mu, var, full_cov=False, Y_metadata=None):
        s2 = self.gaussian_variance(Y_metadata)
        if full_cov:
            return mu, var + s2 * torch.eye(mu.shape[0], dtype=mu.dtype, device=mu.device)
        return mu, var + s2

    def predictive_quantiles(self, mu, var, quantiles, Y_metadata=None):
        sd = torch.sqrt(var + self.gaussian_variance(Y_metadata))
        return [mu + float(norm.ppf(q / 100.0)) * sd for q in quantiles]

    def noise_diagonal(self, N, Y_metadata=None) -> torch.Tensor:
        """Noise added to the Gram diagonal by exact inference, shape (N,)."""
        s2 = self.gaussian_variance(Y_metadata)
        return s2.expand(N) if s2.ndim == 0 else s2.reshape(-1)


class HeteroscedasticGaussian(Gaussian):
    """One noise variance per data point, gathered by
    Y_metadata["output_index"]. GPy: likelihoods/gaussian.py
    HeteroscedasticGaussian."""

    def __init__(self, Y_metadata, gp_link=None, variance=1.0, name="het_Gauss", device=None,
                 dtype=None):
        num = int(np.asarray(Y_metadata["output_index"]).size)
        Likelihood.__init__(self, gp_link or Identity(), name=name, device=device, dtype=dtype)
        self._add_param("variance", np.full(num, float(variance)), transform=Logexp())

    def gaussian_variance(self, Y_metadata=None) -> torch.Tensor:
        v = self.variance.values
        if Y_metadata is not None and "output_index" in Y_metadata:
            idx = np.asarray(Y_metadata["output_index"])
            return v[torch.as_tensor(idx, dtype=torch.long, device=v.device)]  # idx's shape
        return v

    def conditional_variance(self, f):
        """The mean of the variances, the reference's choice."""
        return torch.mean(self.variance.values).expand(f.shape)

    def noise_diagonal(self, N, Y_metadata=None) -> torch.Tensor:
        return self.gaussian_variance(Y_metadata).reshape(-1)
