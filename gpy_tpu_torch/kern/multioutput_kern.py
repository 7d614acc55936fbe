"""Multi-output kernels with cross-covariances, derivative observations among them.

Counterpart of gpy_tpu/kern/multioutput_kern.py:24-121 (GPy/kern/src/
multioutput_kern.py, multioutput_derivative_kern.py, diff_kern.py).

DiffKern derives every derivative covariance from its base kernel by
autodiff, as the reference does: torch.func.grad of the base kernel's
per-pair evaluation `_k_pair`, vmapped over the Gram, which works for any
base kernel. `_k_pair` is plain torch ops, since torch.func cannot trace the
ctypes launch of the RBF Gram kernel; the reference does not reach its
Pallas kernel there either (1 x 1 Grams). The base kernel's own block, the
f-f block, still goes through base.K, so on the card an RBF base launches
the Gram kernel there.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.func import grad, vmap

from .kern import Kern

__all__ = ["DiffKern", "MultioutputKern", "MultioutputDerivativeKern"]


def _pairwise(fn, X, X2):
    """The (N, M) matrix fn(X[i], X2[j])."""
    return vmap(vmap(fn, in_dims=(None, 0)), in_dims=(0, None))(X, X2)


def _d2(k_pair, di, dj):
    """(x, x2) -> d^2 k(x, x2) / dx_di dx2_dj."""
    return lambda x, x2: grad(lambda a: grad(lambda b: k_pair(a, b))(x2)[dj])(x)[di]


class DiffKern(Kern):
    """The derivative of a latent GP with respect to input column `dimension`.

    GPy: diff_kern.py. K(X, X2) = d^2 k / dx_d dx'_d; the cross covariance
    with the base GP is dk/dx_d or dk/dx'_d (cross_K, used by
    MultioutputKern)."""

    def __init__(self, base_kern: Kern, dimension: int, name="DiffKern", device=None,
                 dtype=None):
        super().__init__(base_kern.input_dim, None, name, device=device, dtype=dtype)
        self.base_kern = base_kern
        self.dimension = int(dimension)

    def K(self, X, X2=None):
        d = self.dimension
        return _pairwise(_d2(self.base_kern._k_pair, d, d), X, X if X2 is None else X2)

    def Kdiag(self, X):
        d = self.dimension
        return vmap(_d2(self.base_kern._k_pair, d, d))(X, X)

    def cross_K(self, X, X2, base_first: bool):
        """cov(f(x), df/dx'_d (x')) if base_first, else cov(df/dx_d (x), f(x'))."""
        d, k = self.dimension, self.base_kern._k_pair
        if base_first:
            def kx(x, x2):
                return grad(lambda b: k(x, b))(x2)[d]
        else:
            def kx(x, x2):
                return grad(lambda a: k(a, x2))(x)[d]
        return _pairwise(kx, X, X2)


def _cross_cov(ki: Kern, kj: Kern, X, X2):
    """The covariance between output blocks i and j: zero unless ki and kj
    are one kernel or derive from one base kernel (one Python object)."""
    if ki is kj:
        return ki.K(X, X2)
    if isinstance(ki, DiffKern) and not isinstance(kj, DiffKern) and ki.base_kern is kj:
        return ki.cross_K(X, X2, base_first=False)
    if isinstance(kj, DiffKern) and not isinstance(ki, DiffKern) and kj.base_kern is ki:
        return kj.cross_K(X, X2, base_first=True)
    if isinstance(ki, DiffKern) and isinstance(kj, DiffKern) and ki.base_kern is kj.base_kern:
        return _pairwise(_d2(ki.base_kern._k_pair, ki.dimension, kj.dimension), X, X2)
    return torch.zeros((X.shape[0], X2.shape[0]), dtype=X.dtype, device=X.device)


class MultioutputKern(Kern):
    """Outputs over shared or linked latent functions.

    X carries the output index in its last column (util.multioutput.
    build_XY); block (a, b) of the Gram is the cross covariance of kernels
    a and b. As the reference, every block is computed over all rows and
    masked to its own. GPy: multioutput_kern.py. `cross_covariances` is
    accepted for GPy's signature and not used, as in the reference."""

    def __init__(self, kernels, cross_covariances=None, name="MultioutputKern", device=None,
                 dtype=None):
        if not isinstance(kernels, (list, tuple)):
            kernels = [kernels]
        input_dim = max(k.input_dim for k in kernels) + 1
        super().__init__(input_dim, np.arange(input_dim), name, device=device, dtype=dtype)
        self.parts = list(kernels)

    @staticmethod
    def _split(X):
        return X[:, :-1], X[:, -1].detach().to(torch.int64)

    def K(self, X, X2=None):
        Xv, i1 = self._split(X)
        X2v, i2 = (Xv, i1) if X2 is None else self._split(X2)
        out = torch.zeros((Xv.shape[0], X2v.shape[0]), dtype=Xv.dtype, device=Xv.device)
        for a, ka in enumerate(self.parts):
            for b, kb in enumerate(self.parts):
                mask = (i1[:, None] == a) & (i2[None, :] == b)
                out = out + torch.where(mask, _cross_cov(ka, kb, Xv, X2v), 0.0)
        return out

    def Kdiag(self, X):
        Xv, i1 = self._split(X)
        out = torch.zeros(Xv.shape[0], dtype=Xv.dtype, device=Xv.device)
        for a, ka in enumerate(self.parts):
            out = out + torch.where(i1 == a, ka.Kdiag(Xv), 0.0)
        return out


class MultioutputDerivativeKern(MultioutputKern):
    """GPy's name (multioutput_derivative_kern.py): the cross covariances
    between a GP and its DiffKern derivatives are MultioutputKern's."""
