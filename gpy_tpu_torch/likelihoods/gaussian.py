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

    def conditional_mean(self, f):
        return self.gp_link.transf(f)

    def conditional_variance(self, f):
        return self.variance.values.expand(f.shape)

    def variational_expectations(self, Y, m, v, Y_metadata=None):
        """Closed form E_q[log N(y; f, s2)]."""
        s2 = self.gaussian_variance(Y_metadata)
        return -0.5 * torch.log(2 * math.pi * s2) - 0.5 * ((Y - m) ** 2 + v) / s2

    def moments_match_ep(self, Y, tau, v, Y_metadata=None, degree=None):
        """The site moments in closed form."""
        s2 = self.gaussian_variance(Y_metadata)
        sigma2 = 1.0 / tau
        mu = v / tau
        Y = self._as_tensor(Y, mu)
        sum_var = s2 + sigma2
        logZ = -0.5 * torch.log(2 * math.pi * sum_var) - 0.5 * (Y - mu) ** 2 / sum_var
        return logZ, mu + sigma2 * (Y - mu) / sum_var, sigma2 - sigma2**2 / sum_var

    def predictive_values(self, mu, var, full_cov=False, Y_metadata=None):
        s2 = self.gaussian_variance(Y_metadata)
        if full_cov:
            return mu, var + s2 * torch.eye(mu.shape[0], dtype=mu.dtype, device=mu.device)
        return mu, var + s2

    def predictive_mean(self, mu, var, Y_metadata=None):
        return mu

    def predictive_variance(self, mu, var, predictive_mean=None, Y_metadata=None):
        return var + self.gaussian_variance(Y_metadata)

    def predictive_quantiles(self, mu, var, quantiles, Y_metadata=None, **kw):
        sd = torch.sqrt(var + self.gaussian_variance(Y_metadata))
        return [mu + float(norm.ppf(q / 100.0)) * sd for q in quantiles]

    def log_predictive_density(self, y_test, mu_star, var_star, Y_metadata=None):
        t = var_star + self.gaussian_variance(Y_metadata)
        y = self._as_tensor(y_test, mu_star)
        return -0.5 * torch.log(2 * math.pi * t) - 0.5 * (y - mu_star) ** 2 / t

    def samples_given_f(self, gen, f, Y_metadata=None):
        eps = torch.randn(f.shape, generator=gen, dtype=f.dtype, device=f.device)
        return f + torch.sqrt(self.gaussian_variance(Y_metadata)) * eps

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
