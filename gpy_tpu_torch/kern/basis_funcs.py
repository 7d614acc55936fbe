"""Explicit basis-function kernels: K = v phi(X) phi(X2)'.

Counterpart of gpy_tpu/kern/basis_funcs.py:26-122 (GPy/kern/src/
basis_funcs.py: BasisFuncKernel:10, PolynomialBasisFuncKernel:105,
LinearSlopeBasisFuncKernel:126, ChangePointBasisFuncKernel:148,
DomainKernel:163, LogisticBasisFuncKernel:177). Each K is one product of
the feature matrices. The kernels' constants (start, stop, changepoint,
centers) live on the kernel's device, and every feature takes X's dtype.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device, resolve_dtype
from ..core.transformations import Logexp
from .kern import Kern

__all__ = ["BasisFuncKernel", "PolynomialBasisFuncKernel", "LinearSlopeBasisFuncKernel",
           "ChangePointBasisFuncKernel", "DomainKernel", "LogisticBasisFuncKernel"]


class BasisFuncKernel(Kern):
    def __init__(self, input_dim, variance=1.0, active_dims=None, ARD=False, name="basis_func",
                 device=None, dtype=None):
        super().__init__(input_dim, active_dims, name, device=device, dtype=dtype)
        self.ARD = bool(ARD)
        self._add_param("variance", variance, transform=Logexp())

    def _const(self, a) -> torch.Tensor:
        """A constant of the kernel as a tensor on its device."""
        return torch.tensor(np.asarray(a, dtype=np.float64), dtype=resolve_dtype(self._dtype_arg),
                            device=resolve_device(self._device_arg))

    def _phi(self, X):
        raise NotImplementedError

    def phi(self, X):
        return self._phi(self._slice(X))

    def K(self, X, X2=None):
        p1 = self._phi(self._slice(X))
        p2 = p1 if X2 is None else self._phi(self._slice(X2))
        v = self.variance.values
        if self.ARD:
            return (p1 * v) @ p2.T
        return v * (p1 @ p2.T)

    def Kdiag(self, X):
        p = self._phi(self._slice(X))
        v = self.variance.values
        if self.ARD:
            return torch.sum(p * v * p, dim=1)
        return v * torch.sum(p * p, dim=1)

    def posterior_inf(self, X, posterior):
        """Mean and covariance of the basis-function weights under the GP
        posterior. GPy: basis_funcs.py:80-88."""
        p = self.phi(X)
        v = self.variance.values
        phi_alpha = v * p
        mean = phi_alpha.T @ posterior.woodbury_vector
        eye = torch.eye(p.shape[1], dtype=p.dtype, device=p.device)
        cov = v * eye - phi_alpha.T @ posterior.woodbury_inv @ phi_alpha
        return mean, cov


class PolynomialBasisFuncKernel(BasisFuncKernel):
    """phi = [1, x, ..., x^degree]; with ARD a variance per column."""

    def __init__(self, input_dim, degree, variance=1.0, active_dims=None, ARD=True,
                 name="polynomial_basis", device=None, dtype=None):
        self.degree = int(degree)
        if ARD:
            variance = np.full((degree + 1,), float(variance))
        super().__init__(input_dim, variance, active_dims, ARD, name, device=device, dtype=dtype)

    def _phi(self, X):
        return torch.cat([X ** i for i in range(self.degree + 1)], dim=1)


class LinearSlopeBasisFuncKernel(BasisFuncKernel):
    """A slope active between start and stop. GPy: basis_funcs.py:126."""

    def __init__(self, input_dim, start, stop, variance=1.0, active_dims=None, ARD=False,
                 name="linear_slope", device=None, dtype=None):
        super().__init__(input_dim, variance, active_dims, ARD, name, device=device, dtype=dtype)
        self.start = self._const(start)
        self.stop = self._const(stop)

    def _phi(self, X):
        return torch.clamp(X, self.start, self.stop) - (self.stop + self.start) / 2.0


class ChangePointBasisFuncKernel(BasisFuncKernel):
    """phi = -1 before the changepoint, 1 from it on."""

    def __init__(self, input_dim, changepoint, variance=1.0, active_dims=None, ARD=False,
                 name="changepoint", device=None, dtype=None):
        super().__init__(input_dim, variance, active_dims, ARD, name, device=device, dtype=dtype)
        self.changepoint = self._const(changepoint)

    def _phi(self, X):
        return 2.0 * (X >= self.changepoint).to(X.dtype) - 1.0


class DomainKernel(LinearSlopeBasisFuncKernel):
    """The indicator of start < x < stop. GPy: basis_funcs.py:163."""

    def __init__(self, input_dim, start, stop, variance=1.0, active_dims=None, ARD=False,
                 name="constant_domain", device=None, dtype=None):
        super().__init__(input_dim, start, stop, variance, active_dims, ARD, name, device=device,
                         dtype=dtype)

    def _phi(self, X):
        return ((X > self.start) & (X < self.stop)).to(X.dtype)


class LogisticBasisFuncKernel(BasisFuncKernel):
    """Smooth changepoints at the centers with learnable slopes (one per
    center with ARD_slope). GPy: basis_funcs.py:177."""

    def __init__(self, input_dim, centers, variance=1.0, slope=1.0, active_dims=None,
                 ARD=False, ARD_slope=True, name="logistic", device=None, dtype=None):
        super().__init__(input_dim, variance, active_dims, ARD, name, device=device, dtype=dtype)
        self.centers = self._const(np.asarray(centers, dtype=np.float64).reshape(1, -1))
        nslopes = self.centers.shape[1] if ARD_slope else 1
        self._add_param("slope", np.full((nslopes,), float(slope)))

    def _phi(self, X):
        z = self.slope.values * (X - self.centers)
        return torch.nan_to_num(1.0 / (1.0 + torch.exp(-torch.clamp(z, -30, 30))))
