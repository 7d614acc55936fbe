"""Coregionalization and multi-output index kernels.

Counterpart of gpy_tpu/kern/coregionalize.py:23-146 (GPy/kern/src/
coregionalize.py Coregionalize:16, K:82; independent_outputs.py
IndependentOutputs, Hierarchical).

An index column of X is truncated to an integer toward zero, as
jnp.asarray(x, int32) truncates it, and carries no gradient. Coregionalize
computes K as the one-hot product E1 (B E2'), as the reference does: one
small matmul whose backward, dB = E1' dK E2, is a matmul too. The gather
B[ix1][:, ix2] would autodiff to an atomic scatter of N * M updates into
the (P, P) matrix B. IndependentOutputs and Hierarchical are masked sums
(torch.where) over the wrapped kernels.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.transformations import Logexp
from .kern import Kern

__all__ = ["Coregionalize", "IndependentOutputs", "Hierarchical"]


def _index(col: torch.Tensor) -> torch.Tensor:
    """An index column as int64, truncated toward zero, without a gradient."""
    return col.detach().to(torch.int64)


class Coregionalize(Kern):
    """ICM coregionalization matrix B = W W' + diag(kappa), indexed by the
    integer output column of X. GPy: coregionalize.py:16-130.

    With no W given, W is drawn from numpy's global generator as the
    reference draws it, so np.random.seed(s) gives both packages the same
    start."""

    def __init__(self, input_dim=1, output_dim=1, rank=1, W=None, kappa=None,
                 active_dims=None, name="coregion", device=None, dtype=None):
        super().__init__(input_dim, active_dims, name, device=device, dtype=dtype)
        self.output_dim = int(output_dim)
        self.rank = int(rank)
        if self.rank > output_dim:
            raise ValueError("Rank cannot be greater than output_dim")
        if W is None:
            W = 0.5 * np.random.randn(output_dim, rank) / np.sqrt(rank)
        if kappa is None:
            kappa = 0.5 * np.ones(output_dim)
        self._add_param("W", np.asarray(W, dtype=float))
        self._add_param("kappa", np.asarray(kappa, dtype=float), transform=Logexp())

    @property
    def B(self) -> torch.Tensor:
        W = self.W.values
        return W @ W.T + torch.diag(self.kappa.values)

    def _onehot(self, X: torch.Tensor) -> torch.Tensor:
        ix = _index(X[:, 0])
        return (ix[:, None] == torch.arange(self.output_dim, device=X.device)).to(X.dtype)

    def K(self, X, X2=None):
        E1 = self._onehot(self._slice(X))
        E2 = E1 if X2 is None else self._onehot(self._slice(X2))
        return E1 @ (self.B.to(X.dtype) @ E2.T)

    def Kdiag(self, X):
        return self._onehot(self._slice(X)) @ torch.diagonal(self.B.to(X.dtype))


class IndependentOutputs(Kern):
    """Block-diagonal multi-output: k applies only within one output index.

    GPy: independent_outputs.py. The index is the column `index_dim` (the
    last by default); the wrapped kernel(s) see the remaining columns. With
    several kernels, kernel j serves output j."""

    def __init__(self, kernels, index_dim=-1, name="independ", device=None, dtype=None):
        if not isinstance(kernels, (list, tuple)):
            kernels = [kernels]
        input_dim = max(k.input_dim for k in kernels) + 1
        super().__init__(input_dim, np.arange(input_dim), name, device=device, dtype=dtype)
        self.index_dim = int(index_dim)
        self.parts = list(kernels)
        self.single_kern = len(self.parts) == 1

    def _split(self, X):
        D = X.shape[1]
        cols = [c for c in range(D) if c != self.index_dim % D]
        return X[:, torch.as_tensor(cols, device=X.device)], _index(X[:, self.index_dim])

    def K(self, X, X2=None):
        Xv, ix1 = self._split(X)
        X2v, ix2 = (Xv, ix1) if X2 is None else self._split(X2)
        mask = ix1[:, None] == ix2[None, :]
        if self.single_kern:
            return torch.where(mask, self.parts[0].K(Xv, X2v), 0.0)
        out = torch.zeros((Xv.shape[0], X2v.shape[0]), dtype=Xv.dtype, device=Xv.device)
        for j, k in enumerate(self.parts):
            out = out + torch.where(mask & (ix1[:, None] == j), k.K(Xv, X2v), 0.0)
        return out

    def Kdiag(self, X):
        Xv, ix = self._split(X)
        if self.single_kern:
            return self.parts[0].Kdiag(Xv)
        out = torch.zeros(Xv.shape[0], dtype=Xv.dtype, device=Xv.device)
        for j, k in enumerate(self.parts):
            out = out + torch.where(ix == j, k.Kdiag(Xv), 0.0)
        return out


class Hierarchical(Kern):
    """Hierarchical covariance over nested grouping columns.

    GPy: independent_outputs.py Hierarchical. kernels[0] applies everywhere;
    kernels[l > 0] applies between rows whose group index in extra column
    l - 1 is equal and not negative."""

    def __init__(self, kernels, name="hierarchy", device=None, dtype=None):
        if not all(k.input_dim == kernels[0].input_dim for k in kernels):
            raise ValueError("Hierarchical needs kernels of one input_dim")
        self_levels = len(kernels) - 1
        base_dim = kernels[0].input_dim
        input_dim = base_dim + self_levels
        super().__init__(input_dim, np.arange(input_dim), name, device=device, dtype=dtype)
        self.levels = self_levels
        self.parts = list(kernels)
        self.base_dim = base_dim

    def K(self, X, X2=None):
        Xv = X[:, :self.base_dim]
        X2v = Xv if X2 is None else X2[:, :self.base_dim]
        out = self.parts[0].K(Xv, X2v)
        for lev in range(self.levels):
            i1 = _index(X[:, self.base_dim + lev])
            i2 = i1 if X2 is None else _index(X2[:, self.base_dim + lev])
            mask = (i1[:, None] == i2[None, :]) & (i1[:, None] >= 0)
            out = out + torch.where(mask, self.parts[lev + 1].K(Xv, X2v), 0.0)
        return out

    def Kdiag(self, X):
        return torch.diagonal(self.K(X))
