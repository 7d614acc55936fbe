"""Integral kernels: binned (histogram) observations of a latent RBF GP.

Counterpart of gpy_tpu/kern/integral.py:21-104 (GPy/kern/src/integral.py,
integral_limits.py: Integral_Limits:11, k_xx:55, k_xf:70, and
multidimensional_integral_limits.py). As in GPy, X has columns [t, s] = the
bin's end and start; K(X) is the covariance of the bins' integrals, K(X, X2)
their cross-covariance with the latent function at X2's first column.

Integral is the limits form with s = 0 in K and in Kdiag alike. The
reference's Integral.Kdiag reads a second column its one-column X lacks,
which JAX clamps to the first, so t = s and the diagonal is 0 (ROADMAP
C(x)); here it is the diagonal of K.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.transformations import Logexp
from .kern import Kern

__all__ = ["Integral", "Integral_Limits", "Multidimensional_Integral_Limits"]

SQRT_PI = math.sqrt(math.pi)


def _g(z):
    return z * SQRT_PI * torch.special.erf(z) + torch.exp(-(z * z))


def k_xx(t, tprime, s, sprime, l):
    """Covariance of the integrals of an RBF(l) latent over [s, t] and
    [s', t'] (unit variance)."""
    return 0.5 * (l * l) * (_g((t - sprime) / l) + _g((tprime - s) / l)
                            - _g((t - tprime) / l) - _g((s - sprime) / l))


def k_xf(t, tprime, s, l):
    """Covariance of the integral over [s, t] with the latent at t'."""
    return 0.5 * SQRT_PI * l * (torch.special.erf((t - tprime) / l)
                                + torch.special.erf((tprime - s) / l))


class Integral_Limits(Kern):
    def __init__(self, input_dim, variances=1.0, lengthscale=1.0, ARD=False, active_dims=None,
                 name="integral", device=None, dtype=None):
        super().__init__(input_dim, active_dims, name, device=device, dtype=dtype)
        self._add_param("variances", variances, transform=Logexp())
        self._add_param("lengthscale", lengthscale, transform=Logexp())

    def _vl(self):
        return self.variances.values.reshape(-1)[0], self.lengthscale.values.reshape(-1)[0]

    def K(self, X, X2=None):
        v, l = self._vl()
        t, s = X[:, 0], X[:, 1]
        if X2 is None:
            return v * k_xx(t[:, None], t[None, :], s[:, None], s[None, :], l)
        return v * k_xf(t[:, None], X2[None, :, 0], s[:, None], l)

    def Kdiag(self, X):
        v, l = self._vl()
        t, s = X[:, 0], X[:, 1]
        return v * k_xx(t, t, s, s, l)


class Integral(Integral_Limits):
    """The integral from 0 to x of an RBF latent (GPy: kern/src/integral.py):
    the limits form with s = 0."""

    @staticmethod
    def _from_zero(X):
        return torch.cat([X[:, :1], torch.zeros_like(X[:, :1])], dim=1)

    def K(self, X, X2=None):
        return super().K(self._from_zero(X), X2)

    def Kdiag(self, X):
        return super().Kdiag(self._from_zero(X))


class Multidimensional_Integral_Limits(Kern):
    """The product of per-dimension integral kernels: X's columns are (t_d,
    s_d) pairs. GPy: multidimensional_integral_limits.py."""

    def __init__(self, input_dim, variances=1.0, lengthscale=None, ARD=False, active_dims=None,
                 name="multi_integral", device=None, dtype=None):
        super().__init__(input_dim, active_dims, name, device=device, dtype=dtype)
        if lengthscale is None:
            lengthscale = np.ones(input_dim // 2)
        self._add_param("variances", variances, transform=Logexp())
        self._add_param("lengthscale", np.asarray(lengthscale, dtype=float), transform=Logexp())

    def _factors(self, X, X2, diag):
        ls = self.lengthscale.values.reshape(-1)
        out = self.variances.values.reshape(-1)[0]
        for d in range(X.shape[1] // 2):
            l = ls[d if ls.shape[0] > 1 else 0]
            t, s = X[:, 2 * d], X[:, 2 * d + 1]
            if diag:
                Kd = k_xx(t, t, s, s, l)
            elif X2 is None:
                Kd = k_xx(t[:, None], t[None, :], s[:, None], s[None, :], l)
            else:
                Kd = k_xf(t[:, None], X2[None, :, 2 * d], s[:, None], l)
            out = out * Kd
        return out

    def K(self, X, X2=None):
        return self._factors(X, X2, diag=False)

    def Kdiag(self, X):
        return self._factors(X, None, diag=True)
