"""Stationary kernels: K = f(r), r = scaled distance.

Counterpart of gpy_tpu/kern/stationary.py:42-336 (GPy/kern/src/
stationary.py and rbf.py). RBF.K goes through ops.rbf_gram on every tensor:
on the card that is the CUDA kernel, at every shape. The other families
evaluate K_of_r(safe_sqrt(r2)) in torch ops (RatQuad its K on r2).
`_k_pair`, the same function of one pair of points, is what DiffKern
differentiates by torch.func. Matern32, Matern52 and Exponential are also
the families the fused Gram-matvec (ops/gram_matvec_fused.py) dispatches
on. RBF has the closed-form psi statistics (kern/psi_comp.py), Gaussian or
spike-and-slab by the type of q(X). Exponential, Matern32 and Matern52
define their exact state-space forms, sde(), here; RBF's and RatQuad's
approximate ones are attached by kern/sde.py.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.transformations import Logexp
from ..ops.rbf_gram import rbf_gram, scaled_dist2
from ..util.linalg import safe_sqrt
from .kern import Kern
from .psi_comp import PSICOMP_RBF, PSICOMP_SSRBF, ClosedFormPsi, rbf_psi1, slice_psi_inputs

__all__ = ["Stationary", "RBF", "ExpQuad", "Exponential", "OU", "Matern32", "Matern52", "Cosine",
           "ExpQuadCosine", "Sinc", "RatQuad"]


class Stationary(Kern):
    def __init__(
        self,
        input_dim,
        variance=1.0,
        lengthscale=None,
        ARD=False,
        active_dims=None,
        name="stationary",
        device=None,
        dtype=None,
    ):
        super().__init__(input_dim, active_dims, name, device=device, dtype=dtype)
        self.ARD = bool(ARD)
        if lengthscale is None:
            lengthscale = np.ones(input_dim) if ARD else 1.0
        else:
            lengthscale = np.asarray(lengthscale, dtype=float)
            if ARD:
                lengthscale = np.broadcast_to(lengthscale.reshape(-1), (input_dim,)).copy()
            else:
                lengthscale = float(lengthscale.reshape(-1)[0])
        self._add_param("variance", variance, transform=Logexp())
        self._add_param("lengthscale", lengthscale, transform=Logexp())

    # --- distances --------------------------------------------------------
    def _scaled_dist2(self, X, X2=None):
        """Squared distance of lengthscale-scaled inputs, exactly zero on the
        diagonal when square (ops.rbf_gram.scaled_dist2)."""
        ls = self.lengthscale.values
        Xs = X / ls
        return scaled_dist2(Xs, Xs if X2 is None else X2 / ls)

    # --- API --------------------------------------------------------------
    def K_of_r(self, r):
        raise NotImplementedError

    def _K_of_r2(self, r2):
        """K on the squared scaled distance; r through safe_sqrt, whose
        gradient at r2 = 0 is 0 (the reference's K at coincident points)."""
        return self.K_of_r(safe_sqrt(r2))

    def K(self, X, X2=None):
        X, X2 = self._slice(X), self._slice(X2)
        return self._K_of_r2(self._scaled_dist2(X, X2))

    def _k_pair(self, x, x2):
        # the per-pair form of K for torch.func (DiffKern): direct
        # differences, no Gram kernel
        x, x2 = self._slice(x), self._slice(x2)
        return self._K_of_r2(torch.sum(((x - x2) / self.lengthscale.values) ** 2))

    def Kdiag(self, X):
        v = self.variance.values
        return v * torch.ones(X.shape[0], dtype=X.dtype, device=X.device)

    def input_sensitivity(self, summarize=True):
        v = float(self.variance)
        ls = np.broadcast_to(self.lengthscale.numpy().reshape(-1), (self.input_dim,))
        return v / ls**2


class RBF(ClosedFormPsi, Stationary):
    """Radial basis / squared-exponential. GPy: kern/src/rbf.py:16."""

    def __init__(self, input_dim, variance=1.0, lengthscale=None, ARD=False,
                 active_dims=None, name="rbf", device=None, dtype=None):
        super().__init__(input_dim, variance, lengthscale, ARD, active_dims, name,
                         device=device, dtype=dtype)

    def K(self, X, X2=None):
        # K = v exp(-r2/2) through the Gram kernel; the square Gram's
        # diagonal is exactly v (GPy fills it explicitly)
        X, X2 = self._slice(X), self._slice(X2)
        return rbf_gram(X, X2, self.variance.values, self.lengthscale.values)

    def _K_of_r2(self, r2):
        # no square root, as K: the derivative covariances at r = 0 are v/l^2
        return self.variance.values * torch.exp(-0.5 * r2)

    # closed-form psi statistics (GPy rbf_psi_comp.py); a spike-and-slab
    # q(X) takes the spike-and-slab forms (GPy ssrbf_psi_comp.py)
    def _pc(self, q):
        return PSICOMP_SSRBF() if hasattr(q, "gamma") else PSICOMP_RBF()

    def psi1(self, Z, qX):
        Z, q = slice_psi_inputs(self, Z, qX)
        return rbf_psi1(self, self._pc(q), Z, q)


class ExpQuad(RBF):
    """Alias family: identical covariance, GPy keeps both (stationary.py:623)."""

    def __init__(self, input_dim, variance=1.0, lengthscale=None, ARD=False,
                 active_dims=None, name="ExpQuad", device=None, dtype=None):
        super().__init__(input_dim, variance, lengthscale, ARD, active_dims, name,
                         device=device, dtype=dtype)


class Exponential(Stationary):
    def __init__(self, input_dim, variance=1.0, lengthscale=None, ARD=False,
                 active_dims=None, name="Exponential", device=None, dtype=None):
        super().__init__(input_dim, variance, lengthscale, ARD, active_dims, name,
                         device=device, dtype=dtype)

    def K_of_r(self, r):
        return self.variance.values * torch.exp(-r)

    def sde(self):
        """Matern-1/2 state-space form (F, L, Qc, H, Pinf). GPy:
        sde_matern.py."""
        v = self.variance.values.reshape(1, 1)
        ls = self.lengthscale.values.reshape(-1)[0]
        one = torch.ones_like(v)
        return -1.0 / ls * one, one, 2.0 * v / ls, one, v


class OU(Exponential):
    """Ornstein-Uhlenbeck == Matern 1/2 (GPy: stationary.py:420)."""

    def __init__(self, input_dim, variance=1.0, lengthscale=None, ARD=False,
                 active_dims=None, name="OU", device=None, dtype=None):
        super().__init__(input_dim, variance, lengthscale, ARD, active_dims, name,
                         device=device, dtype=dtype)


class Matern32(Stationary):
    def __init__(self, input_dim, variance=1.0, lengthscale=None, ARD=False,
                 active_dims=None, name="Mat32", device=None, dtype=None):
        super().__init__(input_dim, variance, lengthscale, ARD, active_dims, name,
                         device=device, dtype=dtype)

    def K_of_r(self, r):
        s3 = np.sqrt(3.0)
        return self.variance.values * (1.0 + s3 * r) * torch.exp(-s3 * r)

    def sde(self):
        """State-space form (F, L, Qc, H, Pinf), differentiable in the
        hyperparameters. GPy: stationary.py:520-554."""
        v = self.variance.values.reshape(())
        ls = self.lengthscale.values.reshape(-1)[0]
        lam = np.sqrt(3.0) / ls
        z, o = torch.zeros_like(v), torch.ones_like(v)
        F = torch.stack([torch.stack([z, o]), torch.stack([-(lam**2), -2 * lam])])
        Qc = (12.0 * np.sqrt(3.0) * v / ls**3).reshape(1, 1)
        Pinf = torch.stack([torch.stack([v, z]), torch.stack([z, 3.0 * v / ls**2])])
        return F, torch.stack([z, o]).reshape(2, 1), Qc, torch.stack([o, z]).reshape(1, 2), Pinf


class Matern52(Stationary):
    def __init__(self, input_dim, variance=1.0, lengthscale=None, ARD=False,
                 active_dims=None, name="Mat52", device=None, dtype=None):
        super().__init__(input_dim, variance, lengthscale, ARD, active_dims, name,
                         device=device, dtype=dtype)

    def K_of_r(self, r):
        s5 = np.sqrt(5.0)
        return self.variance.values * (1.0 + s5 * r + 5.0 / 3.0 * r**2) * torch.exp(-s5 * r)

    def sde(self):
        """State-space form (F, L, Qc, H, Pinf). GPy: stationary.py."""
        v = self.variance.values.reshape(())
        ls = self.lengthscale.values.reshape(-1)[0]
        lam = np.sqrt(5.0) / ls
        z, o = torch.zeros_like(v), torch.ones_like(v)
        F = torch.stack([torch.stack([z, o, z]), torch.stack([z, z, o]),
                         torch.stack([-(lam**3), -3 * lam**2, -3 * lam])])
        Qc = (v * 400.0 * np.sqrt(5.0) / 3.0 / ls**5).reshape(1, 1)
        kappa = 5.0 / 3.0 * v / ls**2
        Pinf = torch.stack([torch.stack([v, z, -kappa]), torch.stack([z, kappa, z]),
                            torch.stack([-kappa, z, 25.0 * v / ls**4])])
        return (F, torch.stack([z, z, o]).reshape(3, 1), Qc,
                torch.stack([o, z, z]).reshape(1, 3), Pinf)


class Cosine(Stationary):
    def __init__(self, input_dim, variance=1.0, lengthscale=None, ARD=False,
                 active_dims=None, name="Cosine", device=None, dtype=None):
        super().__init__(input_dim, variance, lengthscale, ARD, active_dims, name,
                         device=device, dtype=dtype)

    def K_of_r(self, r):
        return self.variance.values * torch.cos(r)


class ExpQuadCosine(Stationary):
    """Damped cosine. GPy: stationary.py:682-698."""

    def __init__(self, input_dim, variance=1.0, lengthscale=None, period=1.0, ARD=False,
                 active_dims=None, name="ExpQuadCosine", device=None, dtype=None):
        super().__init__(input_dim, variance, lengthscale, ARD, active_dims, name,
                         device=device, dtype=dtype)
        self._add_param("period", period, transform=Logexp())

    def K_of_r(self, r):
        return (self.variance.values * torch.exp(-2.0 * np.pi**2 * r**2)
                * torch.cos(2.0 * np.pi * r / self.period.values))


class Sinc(Stationary):
    """K = v sinc(2r), the normalized sinc. GPy: stationary.py:717-731."""

    def __init__(self, input_dim, variance=1.0, lengthscale=None, ARD=False,
                 active_dims=None, name="Sinc", device=None, dtype=None):
        super().__init__(input_dim, variance, lengthscale, ARD, active_dims, name,
                         device=device, dtype=dtype)

    def K_of_r(self, r):
        return self.variance.values * torch.sinc(2.0 * r)


class RatQuad(Stationary):
    """Rational quadratic. GPy: stationary.py:739-776."""

    def __init__(self, input_dim, variance=1.0, lengthscale=None, power=2.0, ARD=False,
                 active_dims=None, name="RatQuad", device=None, dtype=None):
        super().__init__(input_dim, variance, lengthscale, ARD, active_dims, name,
                         device=device, dtype=dtype)
        self._add_param("power", power, transform=Logexp())

    def K_of_r(self, r):
        return self._K_of_r2(r**2)

    def _K_of_r2(self, r2):
        # on r2: no square root to differentiate at r = 0
        return self.variance.values * torch.exp(-self.power.values * torch.log1p(r2 / 2.0))
