"""Variational posterior containers for uncertain inputs.

Counterpart of gpy_tpu/core/variational.py:18-79 (GPy/core/
parameterization/variational.py: NormalPrior:25, SpikeAndSlabPrior:39,
NormalPosterior:147, SpikeAndSlabPosterior:175). A posterior is a Module, so
its mean, variance and gamma are raw leaves of the model's parameter tree
and the bound's gradient with respect to them is autograd's.
"""
from __future__ import annotations

import numpy as np
import torch

from .module import Module
from .transformations import Logexp, Logistic

__all__ = ["NormalPosterior", "NormalPrior", "SpikeAndSlabPosterior", "SpikeAndSlabPrior"]


class NormalPosterior(Module):
    """q(X) = prod_n N(x_n | mean_n, diag(variance_n)). GPy: variational.py:147."""

    def __init__(self, means, variances, name="latent_space", device=None, dtype=None):
        super().__init__(name=name, device=device, dtype=dtype)
        self._add_param("mean", np.asarray(means, dtype=float))
        self._add_param("variance", np.asarray(variances, dtype=float), transform=Logexp())

    @property
    def num_data(self):
        return self.mean.shape[0]

    @property
    def input_dim(self):
        return self.mean.shape[1]

    def KL(self):
        """KL(q(X) || N(0, I)). GPy: NormalPrior.KL_divergence."""
        mu, S = self.mean.values, self.variance.values
        return 0.5 * torch.sum(mu**2 + S - torch.log(S) - 1.0)


class NormalPrior:
    """p(X) = N(0, I); the KL lives on the posterior object."""

    def KL_divergence(self, qX):
        return qX.KL()


class SpikeAndSlabPosterior(NormalPosterior):
    """q(x_nq) = gamma_nq N(mean, variance) + (1 - gamma_nq) delta_0, the
    spike-and-slab GPLVM's posterior. GPy: variational.py:175. gamma is
    bounded to (1e-10, 1 - 1e-10), as in the reference."""

    def __init__(self, means, variances, binary_prob, name="ss_latent", device=None,
                 dtype=None):
        super().__init__(means, variances, name=name, device=device, dtype=dtype)
        self._add_param("gamma", np.asarray(binary_prob, dtype=float),
                        transform=Logistic(1e-10, 1 - 1e-10))

    def KL(self, pi=0.5):
        """KL against the spike-and-slab prior with inclusion probability pi:
        the Gaussian part weighted by gamma plus the Bernoulli part."""
        mu, S, g = self.mean.values, self.variance.values, self.gamma.values
        kl_gauss = 0.5 * torch.sum(g * (mu**2 + S - torch.log(S) - 1.0))
        pi = torch.as_tensor(pi, dtype=g.dtype, device=g.device)
        kl_bern = torch.sum(g * (torch.log(g) - torch.log(pi))
                            + (1 - g) * (torch.log1p(-g) - torch.log1p(-pi)))
        return kl_gauss + kl_bern


class SpikeAndSlabPrior:
    def __init__(self, pi=0.5):
        self.pi = pi

    def KL_divergence(self, qX):
        return qX.KL(self.pi)
