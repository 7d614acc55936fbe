"""Miscellaneous kernels: MLP, Poly, Brownian, Spline.

Counterpart of gpy_tpu/kern/misc.py:18-120 (GPy/kern/src/mlp.py:11,
poly.py:10, brownian.py:9, spline.py:9). Brownian has a state-space form
(kern/sde.py).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.transformations import Logexp
from .kern import Kern

__all__ = ["MLP", "Poly", "Brownian", "Spline"]

FOUR_OVER_TAU = 2.0 / np.pi


class MLP(Kern):
    """Arc-sine / neural-network kernel. GPy: mlp.py:11-62."""

    def __init__(self, input_dim, variance=1.0, weight_variance=1.0, bias_variance=1.0,
                 ARD=False, active_dims=None, name="mlp", device=None, dtype=None):
        super().__init__(input_dim, active_dims, name, device=device, dtype=dtype)
        self.ARD = bool(ARD)
        if ARD:
            weight_variance = np.broadcast_to(
                np.asarray(weight_variance, dtype=float).reshape(-1), (input_dim,)).copy()
        self._add_param("variance", variance, transform=Logexp())
        self._add_param("weight_variance", weight_variance, transform=Logexp())
        self._add_param("bias_variance", bias_variance, transform=Logexp())

    def _comp_prod(self, X, X2=None):
        wv, bv = self.weight_variance.values, self.bias_variance.values
        if X2 is None:
            return torch.sum(X * X * wv, dim=1) + bv
        return (X * wv) @ X2.T + bv

    def K(self, X, X2=None):
        X, X2 = self._slice(X), self._slice(X2)
        Xd = torch.sqrt(self._comp_prod(X) + 1.0)
        X2d = Xd if X2 is None else torch.sqrt(self._comp_prod(X2) + 1.0)
        XTX = self._comp_prod(X, X if X2 is None else X2) / Xd[:, None] / X2d[None, :]
        XTX = torch.clamp(XTX, -1.0, 1.0)
        return self.variance.values * FOUR_OVER_TAU * torch.arcsin(XTX)

    def Kdiag(self, X):
        p = self._comp_prod(self._slice(X))
        return self.variance.values * FOUR_OVER_TAU * torch.arcsin(p / (p + 1.0))


class Poly(Kern):
    """k = v * (scale * x.x' + bias)^order. GPy: poly.py:10."""

    def __init__(self, input_dim, variance=1.0, scale=1.0, bias=1.0, order=3.0,
                 active_dims=None, name="poly", device=None, dtype=None):
        super().__init__(input_dim, active_dims, name, device=device, dtype=dtype)
        if order < 1:
            raise ValueError(f"Poly needs order >= 1, not {order}")
        self.order = float(order)
        self._add_param("variance", variance, transform=Logexp())
        self._add_param("scale", scale, transform=Logexp())
        self._add_param("bias", bias, transform=Logexp())

    def _of_dot(self, dp):
        return self.variance.values * (self.scale.values * dp + self.bias.values) ** self.order

    def K(self, X, X2=None):
        X, X2 = self._slice(X), self._slice(X2)
        return self._of_dot(X @ (X if X2 is None else X2).T)

    def Kdiag(self, X):
        X = self._slice(X)
        return self._of_dot(torch.sum(X * X, dim=-1))


class Brownian(Kern):
    """Brownian motion: k = v * min(|x|, |x'|) for same-sign pairs, 0 across
    zero. GPy: brownian.py:9."""

    def __init__(self, input_dim=1, variance=1.0, active_dims=None, name="Brownian",
                 device=None, dtype=None):
        if input_dim != 1:
            raise ValueError("Brownian motion in 1D only")
        super().__init__(input_dim, active_dims, name, device=device, dtype=dtype)
        self._add_param("variance", variance, transform=Logexp())

    def K(self, X, X2=None):
        X = self._slice(X)
        X2 = X if X2 is None else self._slice(X2)
        same_sign = torch.sign(X) == torch.sign(X2.T)
        mins = torch.minimum(torch.abs(X), torch.abs(X2.T))
        return self.variance.values * torch.where(same_sign, mins, torch.zeros_like(mins))

    def Kdiag(self, X):
        return self.variance.values * torch.abs(self._slice(X)[:, 0])


class Spline(Kern):
    """Cubic-spline kernel. GPy: spline.py:9-36."""

    def __init__(self, input_dim=1, variance=1.0, c=1.0, active_dims=None, name="spline",
                 device=None, dtype=None):
        if input_dim != 1:
            raise ValueError("Spline in 1D only")
        super().__init__(input_dim, active_dims, name, device=device, dtype=dtype)
        self._add_param("variance", variance, transform=Logexp())
        self._add_param("c", c, transform=Logexp())

    def K(self, X, X2=None):
        X = self._slice(X)
        X2 = X if X2 is None else self._slice(X2)
        v, c = self.variance.values, self.c.values
        t1 = (X + 8.0) * (X2.T + 8.0) / 16.0
        t2 = torch.abs((X - X2.T) / 16.0) ** 3
        t3 = ((X + 8.0) / 16.0) ** 3 + ((X2.T + 8.0) / 16.0) ** 3
        return v**2 * (1.0 + (1.0 + c) * t1 + c / 3.0 * (t2 - t3))

    def Kdiag(self, X):
        return torch.diagonal(self.K(X))
