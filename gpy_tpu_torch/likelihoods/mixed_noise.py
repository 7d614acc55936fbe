"""Index-routed likelihoods for multi-output models.

Counterpart of gpy_tpu/likelihoods/mixed_noise.py:19-111 (GPy/likelihoods/
mixed_noise.py MixedNoise:14, multioutput_likelihood.py
MultioutputLikelihood:20). Y_metadata["output_index"] picks each row's
sub-likelihood. MixedNoise gathers the variances by a one-hot product,
whose backward is a matmul, not an atomic scatter into P variances.
MultioutputLikelihood evaluates every sub-likelihood on every row and keeps
each row's own with torch.where.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from scipy.stats import norm

from .gaussian import Gaussian
from .likelihood import Likelihood

__all__ = ["MixedNoise", "MultioutputLikelihood"]


class _IndexCache:
    """Y_metadata["output_index"] as int64 tensors on the device, its shape
    kept. A numpy index is copied to the device once and kept beside the
    array it came from: the copy is a host sync, and the EP loop reads the
    index every sweep."""

    def __init__(self):
        self._kept = {}

    def __call__(self, Y_metadata, like: torch.Tensor) -> torch.Tensor:
        if Y_metadata is None or "output_index" not in Y_metadata:
            raise ValueError("this likelihood needs Y_metadata['output_index']")
        idx = Y_metadata["output_index"]
        if torch.is_tensor(idx):
            return idx.to(device=like.device, dtype=torch.int64)
        key = (id(idx), like.device)
        kept = self._kept.get(key)
        if kept is None or kept[0] is not idx:
            kept = (idx, torch.as_tensor(np.asarray(idx).astype(np.int64), device=like.device))
            self._kept = {key: kept}
        return kept[1]


def _sub_metadata(Y_metadata):
    """The metadata a sub-likelihood sees: all but the output index, or None."""
    sub = {k: v for k, v in (Y_metadata or {}).items() if k != "output_index"}
    return sub or None


class MixedNoise(Likelihood):
    """One Gaussian noise variance per output index (coregionalized
    regression). GPy: mixed_noise.py:14."""

    def __init__(self, likelihoods_list, name="mixed_noise", device=None, dtype=None):
        super().__init__(None, name=name, device=device, dtype=dtype)
        if not all(isinstance(lik, Gaussian) for lik in likelihoods_list):
            raise ValueError("MixedNoise takes Gaussian likelihoods only")
        self.likelihoods_list = list(likelihoods_list)
        self._output_index = _IndexCache()

    def gaussian_variance(self, Y_metadata=None) -> torch.Tensor:
        """Each row's noise variance, in the shape of the output index."""
        variances = torch.stack([lik.variance.values for lik in self.likelihoods_list])
        idx = self._output_index(Y_metadata, variances)
        E = (idx.reshape(-1, 1) == torch.arange(variances.shape[0], device=idx.device))
        return (E.to(variances.dtype) @ variances).reshape(idx.shape)

    def noise_diagonal(self, N, Y_metadata=None) -> torch.Tensor:
        return self.gaussian_variance(Y_metadata).reshape(-1)

    def logpdf_link(self, link_f, y, Y_metadata=None):
        s2 = self.gaussian_variance(Y_metadata)
        return -0.5 * torch.log(2 * math.pi * s2) - 0.5 * (y - link_f) ** 2 / s2

    def conditional_mean(self, f):
        return f

    def predictive_values(self, mu, var, full_cov=False, Y_metadata=None):
        """Mean and variance of y*; the noise is added to var elementwise
        whatever full_cov says, as the reference does."""
        return mu, var + self.gaussian_variance(Y_metadata)

    def predictive_quantiles(self, mu, var, quantiles, Y_metadata=None, **kw):
        sd = torch.sqrt(var + self.gaussian_variance(Y_metadata))
        return [mu + float(norm.ppf(q / 100.0)) * sd for q in quantiles]

    def samples_given_f(self, gen: torch.Generator, f, Y_metadata=None):
        eps = torch.randn(f.shape, generator=gen, dtype=f.dtype, device=f.device)
        return f + torch.sqrt(self.gaussian_variance(Y_metadata)) * eps


class MultioutputLikelihood(Likelihood):
    """Heterogeneous likelihoods routed by Y_metadata["output_index"].

    GPy: multioutput_likelihood.py:20. EP's site moments come from the base
    class's Gauss-Hermite moments_match_ep through this logpdf. An output
    index of shape (N, 1) broadcasts against the quadrature's node axis
    (N, P); one of shape (N,) does not."""

    def __init__(self, likelihoods_list, name="multioutput_likelihood", device=None,
                 dtype=None):
        super().__init__(None, name=name, device=device, dtype=dtype)
        self.likelihoods_list = list(likelihoods_list)
        self._output_index = _IndexCache()

    def _route(self, shape, Y_metadata, like, per_lik):
        """Each row's value of per_lik(j, lik) in `shape`: the value of its
        own sub-likelihood."""
        idx = self._output_index(Y_metadata, like)
        out = torch.zeros(shape, dtype=like.dtype, device=like.device)
        for j, lik in enumerate(self.likelihoods_list):
            out = torch.where((idx == j).expand(shape), per_lik(j, lik), out)
        return out

    def logpdf(self, f, y, Y_metadata=None):
        y = self._as_tensor(y, f)
        sub = _sub_metadata(Y_metadata)
        return self._route(torch.broadcast_shapes(f.shape, y.shape), Y_metadata, f,
                           lambda j, lik: lik.logpdf(f, y, sub))

    def variational_expectations(self, Y, m, v, Y_metadata=None, gh_points_=20):
        sub = _sub_metadata(Y_metadata)
        return self._route(m.shape, Y_metadata, m,
                           lambda j, lik: lik.variational_expectations(Y, m, v, sub))

    def predictive_values(self, mu, var, full_cov=False, Y_metadata=None):
        sub = _sub_metadata(Y_metadata)
        parts = [lik.predictive_values(mu, var, full_cov, sub) for lik in self.likelihoods_list]
        mean = self._route(mu.shape, Y_metadata, mu, lambda j, lik: parts[j][0])
        return mean, self._route(var.shape, Y_metadata, var, lambda j, lik: parts[j][1])
