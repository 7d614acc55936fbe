"""Static kernels (no dependence on X values): White, Bias, Fixed,
WhiteHeteroscedastic and Precomputed.

Counterpart of gpy_tpu/kern/static.py:23-119 (GPy/kern/src/static.py).
White and Bias have closed-form psi statistics; the others take the base
class's quadrature.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device, resolve_dtype
from ..core.transformations import Logexp
from .kern import Kern

__all__ = ["Static", "White", "Bias", "Fixed", "WhiteHeteroscedastic", "Precomputed"]


class Static(Kern):
    def __init__(self, input_dim, variance, active_dims, name, device=None, dtype=None):
        super().__init__(input_dim, active_dims, name, device=device, dtype=dtype)
        self._add_param("variance", variance, transform=Logexp())

    def Kdiag(self, X):
        return self.variance.values * torch.ones(X.shape[0], dtype=X.dtype, device=X.device)


class White(Static):
    """v * I (zero cross-covariance)."""

    def __init__(self, input_dim=1, variance=1.0, active_dims=None, name="white",
                 device=None, dtype=None):
        super().__init__(input_dim, variance, active_dims, name, device=device, dtype=dtype)

    def K(self, X, X2=None):
        if X2 is None:
            return self.variance.values * torch.eye(X.shape[0], dtype=X.dtype, device=X.device)
        return torch.zeros((X.shape[0], X2.shape[0]), dtype=X.dtype, device=X.device)

    def psi0(self, Z, qX):
        return self.variance.values * torch.ones(qX.mean.shape[0], dtype=Z.dtype, device=Z.device)

    def psi1(self, Z, qX):
        return torch.zeros((qX.mean.shape[0], Z.shape[0]), dtype=Z.dtype, device=Z.device)

    def psi2n(self, Z, qX):
        M = Z.shape[0]
        return torch.zeros((qX.mean.shape[0], M, M), dtype=Z.dtype, device=Z.device)


class Bias(Static):
    """Constant covariance v."""

    def __init__(self, input_dim=1, variance=1.0, active_dims=None, name="bias",
                 device=None, dtype=None):
        super().__init__(input_dim, variance, active_dims, name, device=device, dtype=dtype)

    def K(self, X, X2=None):
        n2 = X.shape[0] if X2 is None else X2.shape[0]
        return self.variance.values * torch.ones((X.shape[0], n2), dtype=X.dtype, device=X.device)

    def psi0(self, Z, qX):
        return self.variance.values * torch.ones(qX.mean.shape[0], dtype=Z.dtype, device=Z.device)

    def psi1(self, Z, qX):
        return self.variance.values * torch.ones((qX.mean.shape[0], Z.shape[0]), dtype=Z.dtype,
                                                 device=Z.device)

    def psi2n(self, Z, qX):
        M = Z.shape[0]
        return self.variance.values**2 * torch.ones((qX.mean.shape[0], M, M), dtype=Z.dtype,
                                                    device=Z.device)


class Fixed(Static):
    """v * a fixed covariance matrix (zero cross-covariance). GPy: static.py Fixed."""

    def __init__(self, input_dim, covariance_matrix, variance=1.0, active_dims=None, name="fixed",
                 device=None, dtype=None):
        super().__init__(input_dim, variance, active_dims, name, device=device, dtype=dtype)
        self.fixed_K = torch.tensor(np.asarray(covariance_matrix, dtype=np.float64),
                                    dtype=resolve_dtype(dtype), device=resolve_device(device))

    def K(self, X, X2=None):
        if X2 is None:
            return self.variance.values * self.fixed_K
        return torch.zeros((X.shape[0], X2.shape[0]), dtype=X.dtype, device=X.device)

    def Kdiag(self, X):
        return self.variance.values * torch.diagonal(self.fixed_K)


class WhiteHeteroscedastic(Static):
    """A learned noise variance per data point on the diagonal. GPy: static.py."""

    def __init__(self, input_dim=1, num_data=1, variance=1.0, active_dims=None,
                 name="white_hetero", device=None, dtype=None):
        Kern.__init__(self, input_dim, active_dims, name, device=device, dtype=dtype)
        self._add_param("variance", np.full(num_data, float(variance)), transform=Logexp())

    def K(self, X, X2=None):
        if X2 is None:
            return torch.diag(self.variance.values)
        return torch.zeros((X.shape[0], X2.shape[0]), dtype=X.dtype, device=X.device)

    def Kdiag(self, X):
        return self.variance.values


class Precomputed(Fixed):
    """A precomputed covariance indexed by the integer first column of X.
    GPy: static.py Precomputed."""

    def __init__(self, input_dim, covariance_matrix, variance=1.0, active_dims=None,
                 name="precomputed", device=None, dtype=None):
        super().__init__(input_dim, covariance_matrix, variance, active_dims, name,
                         device=device, dtype=dtype)

    def K(self, X, X2=None):
        i1 = X[:, 0].long()
        i2 = i1 if X2 is None else X2[:, 0].long()
        return self.variance.values * self.fixed_K[i1[:, None], i2[None, :]]

    def Kdiag(self, X):
        i1 = X[:, 0].long()
        return self.variance.values * self.fixed_K[i1, i1]
