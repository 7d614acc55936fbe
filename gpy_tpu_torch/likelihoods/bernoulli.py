"""Bernoulli likelihood with the analytic probit EP moments.

Counterpart of gpy_tpu/likelihoods/bernoulli.py:19-103 (GPy/likelihoods/
bernoulli.py): the probit moments of Rasmussen & Williams 3.58, the
Heaviside link's truncated-Gaussian moments and the closed-form predictive
mean; every other link takes the base class's quadrature.
"""
from __future__ import annotations

import math

import torch
from torch.special import log_ndtr, ndtr

from .likelihood import Likelihood
from .link_functions import Heaviside, Probit

__all__ = ["Bernoulli"]

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def _norm_logpdf(z):
    return -0.5 * z * z - _HALF_LOG_2PI


class Bernoulli(Likelihood):
    log_concave = True  # W >= 0 everywhere (Laplace's Cholesky path)

    def __init__(self, gp_link=None, name="Bernoulli", device=None, dtype=None):
        super().__init__(gp_link or Probit(), name=name, device=device, dtype=dtype)

    def _is_probit(self):
        return isinstance(self.gp_link, Probit)

    def _is_heaviside(self):
        return isinstance(self.gp_link, Heaviside)

    def logpdf_link(self, link_f, y, Y_metadata=None):
        # y in {0, 1}; p = link_f
        p = torch.clamp(link_f, 1e-12, 1 - 1e-12)
        return y * torch.log(p) + (1 - y) * torch.log1p(-p)

    def logpdf(self, f, y, Y_metadata=None):
        if self._is_probit():
            # log Phi(sign * f), sign = 2y - 1: no rounding of Phi near 0 or 1
            return log_ndtr((2.0 * y - 1.0) * f)
        return super().logpdf(f, y, Y_metadata)

    def conditional_mean(self, f):
        return self.gp_link.transf(f)

    def conditional_variance(self, f):
        p = self.gp_link.transf(f)
        return p * (1.0 - p)

    def moments_match_ep(self, Y, tau, v, Y_metadata=None, degree=None):
        """Analytic moment matching: probit (R&W 3.58), or the Heaviside
        link's truncated Gaussian (Z = Phi(z), z = s mu / sigma; GPy's
        bernoulli.py:80-85 names an undefined `a` there)."""
        mu = v / tau
        sigma2 = 1.0 / tau
        if self._is_heaviside():
            s = 2.0 * self._as_tensor(Y, mu) - 1.0
            sigma = torch.sqrt(sigma2)
            z = s * mu / sigma
            logZ = log_ndtr(z)
            ratio = torch.exp(_norm_logpdf(z) - logZ)
            mu_hat = mu + s * sigma * ratio
            sigma2_hat = sigma2 * (1.0 - ratio * (z + ratio))
            return logZ, mu_hat, torch.clamp(sigma2_hat, min=1e-15)
        if not self._is_probit():
            return super().moments_match_ep(Y, tau, v, Y_metadata)
        s = 2.0 * self._as_tensor(Y, mu) - 1.0  # {0, 1} -> {-1, +1}
        denom = torch.sqrt(1.0 + sigma2)
        z = s * mu / denom
        logZ = log_ndtr(z)
        ratio = torch.exp(_norm_logpdf(z) - logZ)  # N(z) / Phi(z) in log space
        mu_hat = mu + s * sigma2 * ratio / denom
        sigma2_hat = sigma2 - sigma2**2 * ratio / (1.0 + sigma2) * (z + ratio)
        return logZ, mu_hat, torch.clamp(sigma2_hat, min=1e-15)

    def predictive_mean(self, mu, var, Y_metadata=None):
        if self._is_probit():
            return ndtr(mu / torch.sqrt(1.0 + var))
        if self._is_heaviside():
            # E[step(f)] under N(mu, var): no latent noise of its own
            return ndtr(mu / torch.sqrt(torch.clamp(var, min=1e-15)))
        return super().predictive_mean(mu, var, Y_metadata)

    def predictive_values(self, mu, var, full_cov=False, Y_metadata=None):
        p = self.predictive_mean(mu, var, Y_metadata)
        return p, p * (1.0 - p)

    def predictive_variance(self, mu, var, predictive_mean=None, Y_metadata=None):
        p = predictive_mean if predictive_mean is not None else self.predictive_mean(mu, var)
        return p * (1.0 - p)

    def samples_given_f(self, gen, f, Y_metadata=None):
        return torch.bernoulli(self.gp_link.transf(f), generator=gen).to(f.dtype)
