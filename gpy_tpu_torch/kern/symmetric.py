"""Symmetry-constrained and split-domain kernels.

Counterpart of gpy_tpu/kern/symmetric.py:17-89 (GPy/kern/src/symmetric.py:6,
splitKern.py: DEtime:10, SplitKern:81, grid_kerns.py: GridRBF). Every base
Gram goes through the base kernel's K, so an RBF base launches B1 for each
(four for a Symmetric K or a SplitKern K).
"""
from __future__ import annotations

import numpy as np
import torch

from .kern import Kern
from .stationary import RBF

__all__ = ["Symmetric", "SplitKern", "DEtime", "GridRBF"]


def _placement(kern, device, dtype):
    """(device, dtype) of a combined kernel: the base kernel's where it has
    parameters, else as given."""
    p = kern._first_param()
    return (device, dtype) if p is None else (p.device, p.dtype)


class Symmetric(Kern):
    """k(x, x') + s k(Ax, x') + s k(x, Ax') + k(Ax, Ax'), s = +1 (even) or
    -1 (odd) through the reflection A."""

    def __init__(self, base_kernel, transform, symmetry_type="even",
                 name="symmetric_kernel", device=None, dtype=None):
        device, dtype = _placement(base_kernel, device, dtype)
        n_dims = int(max(base_kernel.active_dims) + 1)
        super().__init__(n_dims, list(range(n_dims)), name=name, device=device, dtype=dtype)
        if symmetry_type not in ("even", "odd"):
            raise ValueError("symmetry_type must be 'even' or 'odd'")
        self.symmetry_sign = -1.0 if symmetry_type == "odd" else 1.0
        self.base_kernel = base_kernel
        self.A = torch.tensor(np.asarray(transform, dtype=np.float64), dtype=dtype, device=device)

    def K(self, X, X2=None):
        s = self.symmetry_sign
        k = self.base_kernel.K
        XA = X @ self.A
        if X2 is None:
            return k(X) + s * k(XA, X) + s * k(X, XA) + k(XA, XA)
        X2A = X2 @ self.A
        return k(X, X2) + s * k(XA, X2) + s * k(X, X2A) + k(XA, X2A)

    def Kdiag(self, X):
        return torch.diagonal(self.K(X))


class SplitKern(Kern):
    """Two domains, indexed by the last column, share the base kernel k
    within a domain; across them the covariance is k(x, xd) k(xd, x') /
    k(xd, xd) through the divergence point xd. GPy: splitKern.py:81."""

    def __init__(self, kernel, Xd, index_dim=-1, name="SplitKern", device=None, dtype=None):
        device, dtype = _placement(kernel, device, dtype)
        super().__init__(kernel.input_dim + 1, None, name, device=device, dtype=dtype)
        self.base_kern = kernel
        self.Xd = torch.tensor(np.asarray(Xd, dtype=np.float64).reshape(1, -1), dtype=dtype,
                               device=device)
        self.index_dim = index_dim

    def _cross(self, X, X2):
        k = self.base_kern.K
        kd = k(self.Xd)[0, 0]
        return (k(X, self.Xd) @ k(self.Xd, X if X2 is None else X2)) / kd

    def K(self, X, X2=None):
        idx1 = X[:, self.index_dim].to(torch.int32)
        Xv = X[:, :-1]
        idx2 = idx1 if X2 is None else X2[:, self.index_dim].to(torch.int32)
        X2v = None if X2 is None else X2[:, :-1]
        same = idx1[:, None] == idx2[None, :]
        return torch.where(same, self.base_kern.K(Xv, X2v), self._cross(Xv, X2v))

    def Kdiag(self, X):
        return self.base_kern.Kdiag(X[:, :-1])


class DEtime(SplitKern):
    """The time-split kernel of differential expression (GPy:
    splitKern.py:10): SplitKern with an RBF(1) base by default."""

    def __init__(self, kernel=None, Xd=0.0, index_dim=-1, name="DEtime", device=None,
                 dtype=None):
        kernel = kernel or RBF(1, device=device, dtype=dtype)
        super().__init__(kernel, np.atleast_1d(Xd), index_dim, name, device=device, dtype=dtype)


class GridRBF(RBF):
    """The RBF under GPy's grid-kernel name (GPy: grid_kerns.py): the same
    covariance, for the grid models."""

    def __init__(self, input_dim, variance=1.0, lengthscale=None, ARD=False, active_dims=None,
                 name="gridRBF", device=None, dtype=None):
        super().__init__(input_dim, variance, lengthscale, ARD, active_dims, name, device=device,
                         dtype=dtype)
