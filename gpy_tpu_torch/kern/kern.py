"""Kernel base class and combination kernels (Add/Prod).

Counterpart of gpy_tpu/kern/kern.py:27-206 (GPy/kern/src/kern.py and the
active_dims slicing of kernel_slice_operations.py). A kernel is a Module
whose `K(X, X2)` is a function of tensors; gradients with respect to
parameters and inputs come from autograd. The psi statistics (kernel
expectations under a q(X), kern/psi_comp.py) default to Gauss-Hermite
quadrature; RBF, Linear, Bias and White have closed forms, and Add adds the
cross terms of its parts.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..core.module import Module

__all__ = ["Kern", "CombinationKernel", "Add", "Prod"]


class Kern(Module):
    def __init__(self, input_dim: int, active_dims=None, name: str = "kern",
                 device=None, dtype=None):
        super().__init__(name=name, device=device, dtype=dtype)
        self.input_dim = int(input_dim)
        if active_dims is None:
            active_dims = np.arange(input_dim)
        self.active_dims = np.asarray(active_dims, dtype=np.int64).reshape(-1)
        if self.active_dims.size != self.input_dim:
            raise ValueError("active_dims must have input_dim entries")
        self._all_dims = self.active_dims  # effective columns this kernel reads

    # --- slicing ----------------------------------------------------------
    def _slice(self, X):
        if X is None:
            return None
        if X.shape[-1] == self.input_dim and np.array_equal(
            self.active_dims, np.arange(self.input_dim)
        ):
            return X
        a = int(self.active_dims[0])
        if a >= 0 and np.array_equal(self.active_dims, np.arange(a, a + self.input_dim)):
            # a view: no index tensor to copy to the card (a host sync)
            return X[..., a:a + self.input_dim]
        idx = torch.as_tensor(self.active_dims, dtype=torch.long, device=X.device)
        return X[..., idx]

    # --- covariance API ---------------------------------------------------
    def K(self, X, X2=None):
        raise NotImplementedError

    def Kdiag(self, X):
        raise NotImplementedError

    # --- uncertain-input psi statistics (GPy kern.py:146-170) -------------
    # qX: a NormalPosterior-like q(X) with .mean and .variance, (N, Q)
    def psi0(self, Z, qX):
        from .psi_comp import psi0_quadrature

        return psi0_quadrature(self, Z, qX)

    def psi1(self, Z, qX):
        from .psi_comp import psi1_quadrature

        return psi1_quadrature(self, Z, qX)

    def psi2(self, Z, qX):
        """sum_n psi2n, (M, M)."""
        return torch.sum(self.psi2n(Z, qX), dim=0)

    def psi2n(self, Z, qX):
        from .psi_comp import psi2n_quadrature

        return psi2n_quadrature(self, Z, qX)

    def _k_pair(self, x, x2):
        """k(x, x2) of two single points, shape (input columns,), in torch
        ops that torch.func can trace: DiffKern differentiates it twice. By
        default the 1 x 1 Gram; kernels whose K launches a CUDA kernel, or
        combines kernels that may, override it."""
        return self.K(x[None, :], x2[None, :])[0, 0]

    # --- autograd conveniences (GPy's hand-written versions) --------------
    def gradients_X(self, dL_dK, X, X2=None):
        """dL/dX where L = sum(dL_dK * K(X, X2)). GPy: kern.py:172."""
        X = X.detach().requires_grad_(True)
        return torch.autograd.grad(torch.sum(dL_dK * self.K(X, X2)), X)[0]

    def input_sensitivity(self, summarize: bool = True):
        """ARD relevance per input dim. GPy: kern.py:260."""
        return np.zeros(self.input_dim)

    # --- composition ------------------------------------------------------
    def __add__(self, other):
        if not isinstance(other, Kern):
            return NotImplemented
        return Add([self, other])

    def __mul__(self, other):
        if not isinstance(other, Kern):
            return NotImplemented
        return Prod([self, other])


class CombinationKernel(Kern):
    def __init__(self, kernels: Sequence[Kern], name: str):
        all_dims = np.unique(np.concatenate([k._all_dims for k in kernels]))
        input_dim = int(all_dims.max() + 1)
        super().__init__(input_dim, active_dims=np.arange(input_dim), name=name)
        self._all_dims = all_dims
        self.parts = list(kernels)

    def input_sensitivity(self, summarize: bool = True):
        s = np.zeros(self.input_dim)
        for p in self.parts:
            s[p.active_dims] += np.asarray(p.input_sensitivity(summarize)).reshape(-1)
        return s


class Add(CombinationKernel):
    """Sum kernel. GPy: kern/src/add.py (flattens nested sums)."""

    def __init__(self, kernels: Sequence[Kern], name: str = "sum"):
        flat = []
        for k in kernels:
            flat.extend(k.parts if isinstance(k, Add) else [k])
        super().__init__(flat, name)

    def K(self, X, X2=None):
        return sum(p.K(X, X2) for p in self.parts)

    def Kdiag(self, X):
        return sum(p.Kdiag(X) for p in self.parts)

    def _k_pair(self, x, x2):
        return sum(p._k_pair(x, x2) for p in self.parts)

    def psi0(self, Z, qX):
        return sum(p.psi0(Z, qX) for p in self.parts)

    def psi1(self, Z, qX):
        return sum(p.psi1(Z, qX) for p in self.parts)

    def psi2n(self, Z, qX):
        """The parts' psi2n plus the cross terms <K_i(x, Z_m) K_j(x, Z_m')>
        of every pair (gpy_tpu/kern/kern.py:138-170): the exact closed forms
        of psi_comp.cross_psi2n_exact where they exist; else Gauss-Hermite
        quadrature for a Gaussian q(X) with Q <= 4; else, with a warning, the
        product of the two psi1 (biased on overlapping dimensions)."""
        import warnings

        from .psi_comp import cross_psi2n_exact, cross_psi2n_quadrature, moments

        total = sum(p.psi2n(Z, qX) for p in self.parts)
        for i in range(len(self.parts)):
            for j in range(i + 1, len(self.parts)):
                p1, p2 = self.parts[i], self.parts[j]
                cross = cross_psi2n_exact(p1, p2, Z, qX)
                if cross is None:
                    q = moments(qX)
                    Q = q.mean.shape[1]
                    if Q <= 4 and not hasattr(q, "gamma"):
                        cross = cross_psi2n_quadrature(p1, p2, Z, qX)
                    else:
                        warnings.warn(
                            f"Add.psi2: no exact cross term for {type(p1).__name__} x "
                            f"{type(p2).__name__} on overlapping active_dims (Q={Q}); using "
                            "the product-of-psi1 approximation (biased bound).", stacklevel=2)
                        cross = p1.psi1(Z, qX)[:, :, None] * p2.psi1(Z, qX)[:, None, :]
                total = total + cross + cross.transpose(1, 2)
        return total


class Prod(CombinationKernel):
    """Product kernel. GPy: kern/src/prod.py."""

    def __init__(self, kernels: Sequence[Kern], name: str = "mul"):
        flat = []
        for k in kernels:
            flat.extend(k.parts if isinstance(k, Prod) else [k])
        super().__init__(flat, name)

    def K(self, X, X2=None):
        out = self.parts[0].K(X, X2)
        for p in self.parts[1:]:
            out = out * p.K(X, X2)
        return out

    def Kdiag(self, X):
        out = self.parts[0].Kdiag(X)
        for p in self.parts[1:]:
            out = out * p.Kdiag(X)
        return out

    def _k_pair(self, x, x2):
        out = self.parts[0]._k_pair(x, x2)
        for p in self.parts[1:]:
            out = out * p._k_pair(x, x2)
        return out
