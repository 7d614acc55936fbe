"""Linear-family kernels: every K is one product of the inputs.

Counterpart of gpy_tpu/kern/linear.py:18-174 (GPy/kern/src/linear.py
Linear:21, LinearFull:183; trunclinear.py TruncLinear:11,
TruncLinear_inf:95). The products stay torch.matmul, as the reference's stay
outside any Pallas kernel; float32 runs them with TF32 off (config.py).
Linear has the closed-form psi statistics (kern/psi_comp.py), Gaussian or
spike-and-slab by the type of q(X).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.transformations import Logexp
from .kern import Kern
from .psi_comp import PSICOMP_Linear, PSICOMP_SSLinear, ClosedFormPsi

__all__ = ["Linear", "LinearFull", "TruncLinear", "TruncLinear_inf"]


class Linear(ClosedFormPsi, Kern):
    """k(x, x') = sum_q v_q x_q x'_q. GPy: linear.py:21."""

    def __init__(self, input_dim, variances=None, ARD=False, active_dims=None, name="linear",
                 device=None, dtype=None):
        super().__init__(input_dim, active_dims, name, device=device, dtype=dtype)
        self.ARD = bool(ARD)
        if variances is None:
            variances = np.ones(input_dim) if ARD else 1.0
        else:
            variances = np.asarray(variances, dtype=float)
            variances = (np.broadcast_to(variances.reshape(-1), (input_dim,)).copy() if ARD
                         else float(variances.reshape(-1)[0]))
        self._add_param("variances", variances, transform=Logexp())

    def K(self, X, X2=None):
        X, X2 = self._slice(X), self._slice(X2)
        return (X * self.variances.values) @ (X if X2 is None else X2).T

    def Kdiag(self, X):
        X = self._slice(X)
        return torch.sum(self.variances.values * X * X, dim=-1)

    # spike-and-slab q(X) takes GPy's sslinear_psi_comp.py forms
    def _pc(self, q):
        return PSICOMP_SSLinear() if hasattr(q, "gamma") else PSICOMP_Linear()

    def input_sensitivity(self, summarize=True):
        return np.broadcast_to(self.variances.numpy().reshape(-1), (self.input_dim,))


class LinearFull(Kern):
    """k(x, x') = x' (W W' + diag(kappa)) x'. GPy: linear.py:183."""

    def __init__(self, input_dim, rank=1, W=None, kappa=None, active_dims=None,
                 name="linear_full", device=None, dtype=None):
        super().__init__(input_dim, active_dims, name, device=device, dtype=dtype)
        self.rank = int(rank)
        if W is None:
            W = np.ones((input_dim, rank))
        if kappa is None:
            kappa = np.ones(input_dim)
        self._add_param("W", np.asarray(W, dtype=float))
        self._add_param("kappa", np.asarray(kappa, dtype=float), transform=Logexp())

    def _P(self):
        W = self.W.values
        return W @ W.T + torch.diag(self.kappa.values)

    def K(self, X, X2=None):
        X, X2 = self._slice(X), self._slice(X2)
        return X @ self._P() @ (X if X2 is None else X2).T

    def Kdiag(self, X):
        X = self._slice(X)
        return torch.sum((X @ self._P()) * X, dim=-1)


class TruncLinear(Kern):
    """k(x, x') = sum_q v_q max(0, (x_q - d_q)(x'_q - d_q)). GPy: trunclinear.py:11."""

    def __init__(self, input_dim, variances=None, delta=None, ARD=False, active_dims=None,
                 name="trunclinear", device=None, dtype=None):
        super().__init__(input_dim, active_dims, name, device=device, dtype=dtype)
        self.ARD = bool(ARD)
        if variances is None:
            variances = np.ones(input_dim) if ARD else 1.0
        if delta is None:
            delta = np.zeros(input_dim) if ARD else 0.0
        self._add_param("variances", variances, transform=Logexp())
        self._add_param("delta", delta)

    def K(self, X, X2=None):
        X, X2 = self._slice(X), self._slice(X2)
        if X2 is None:
            X2 = X
        d = self.delta.values
        XX = (X - d)[:, None, :] * (X2 - d)[None, :, :]
        XX = torch.maximum(XX, XX.new_zeros(()))  # halves the gradient at a tie, as jnp.maximum
        return torch.sum(self.variances.values * XX, dim=-1)

    def Kdiag(self, X):
        X = self._slice(X)
        return torch.sum(self.variances.values * (X - self.delta.values) ** 2, dim=-1)


class TruncLinear_inf(Kern):
    """The truncated-linear kernel integrated over a break-point interval
    [a, b]: k(x, x') = sum_q v_q (|x - x'|^3 / 6 + x x' (b - a)
    - (x + x') (b^2 - a^2) / 2 + (b^3 - a^3) / 3). GPy: trunclinear.py:110-199."""

    def __init__(self, input_dim, interval, variances=None, ARD=False, active_dims=None,
                 name="trunclinear_inf", device=None, dtype=None):
        super().__init__(input_dim, active_dims, name, device=device, dtype=dtype)
        self.ARD = bool(ARD)
        self.interval = (float(interval[0]), float(interval[1]))
        if variances is None:
            variances = np.ones(input_dim) if ARD else 1.0
        self._add_param("variances", variances, transform=Logexp())

    def _product(self, X, X2):
        a, b = self.interval
        x, x2 = X[:, None, :], X2[None, :, :]
        return (torch.abs(x - x2) ** 3 / 6.0 + x * x2 * (b - a)
                - (x + x2) * (b * b - a * a) / 2.0 + (b**3 - a**3) / 3.0)

    def K(self, X, X2=None):
        X, X2 = self._slice(X), self._slice(X2)
        return torch.sum(self.variances.values * self._product(X, X if X2 is None else X2), dim=-1)

    def Kdiag(self, X):
        X = self._slice(X)
        a, b = self.interval
        tmp = X * X * (b - a) - X * (b * b - a * a) + (b**3 - a**3) / 3.0
        return torch.sum(self.variances.values * tmp, dim=-1)
