"""Posterior container: woodbury representation + prediction math.

Counterpart of gpy_tpu/inference/posterior.py:19-121 (GPy/inference/
latent_function_inference/posterior.py). At uncertain inputs, a q(X*)
with .mean and .variance, prediction goes through the psi statistics
(GPy posterior.py:249-270).
"""
from __future__ import annotations

import torch

from ..util.linalg import dpotri

__all__ = ["Posterior"]


class Posterior:
    """p(f | D) through
        mean(X*) = K_{*x} @ woodbury_vector
        cov(X*)  = K_{**} - K_{*x} @ woodbury_inv @ K_{x*}
    where x is the predictive variable (X for exact GPs)."""

    def __init__(self, woodbury_chol=None, woodbury_vector=None, K=None, woodbury_inv=None):
        self._woodbury_chol = woodbury_chol
        self._woodbury_vector = woodbury_vector
        self._woodbury_inv = woodbury_inv
        self._K = K

    @property
    def woodbury_chol(self):
        return self._woodbury_chol

    @property
    def woodbury_vector(self):
        return self._woodbury_vector

    @property
    def woodbury_inv(self):
        if self._woodbury_inv is None:
            return dpotri(self._woodbury_chol)
        return self._woodbury_inv

    @property
    def K(self):
        return self._K

    def _raw_predict(self, kern, Xnew, pred_var, full_cov: bool = False):
        if hasattr(Xnew, "mean") and hasattr(Xnew, "variance"):
            return self._raw_predict_uncertain(kern, Xnew, pred_var, full_cov)
        Kx = kern.K(pred_var, Xnew)  # (M, N*)
        mu = Kx.T @ self.woodbury_vector
        if full_cov:
            Kxx = kern.K(Xnew)
            if self._woodbury_chol is not None:
                tmp = torch.linalg.solve_triangular(self._woodbury_chol, Kx, upper=False)
                var = Kxx - tmp.T @ tmp
            else:
                var = Kxx - Kx.T @ self.woodbury_inv @ Kx
            var = 0.5 * (var + var.T)
        else:
            Kxx = kern.Kdiag(Xnew)
            if self._woodbury_chol is not None:
                tmp = torch.linalg.solve_triangular(self._woodbury_chol, Kx, upper=False)
                var = (Kxx - torch.sum(tmp * tmp, dim=0))[:, None]
            else:
                var = (Kxx - torch.sum(Kx * (self.woodbury_inv @ Kx), dim=0))[:, None]
            var = torch.clamp(var, min=1e-15)
        return mu, var

    def _raw_predict_uncertain(self, kern, qX, pred_var, full_cov):
        """Mean and total variance at q(X*) = prod_n N(mu_n, diag S_n):
            mu_*  = psi1 la,  la = woodbury_vector
            var_* = la' (psi2_n - psi1 psi1') la + psi0 - tr(Winv psi2_n)
        (E_q Var[f | x] + Var_q E[f | x])."""
        if full_cov:
            raise NotImplementedError("full_cov with uncertain inputs is not implemented "
                                      "(as GPy posterior.py:258)")
        psi0 = kern.psi0(pred_var, qX)
        psi1 = kern.psi1(pred_var, qX)
        psi2n = kern.psi2n(pred_var, qX)
        la = self.woodbury_vector
        mu = psi1 @ la
        tmp = psi2n - psi1[:, :, None] * psi1[:, None, :]
        var = torch.einsum("nmk,md,kd->nd", tmp, la, la) + psi0[:, None]
        var = var - torch.einsum("nmk,mk->n", psi2n, self.woodbury_inv)[:, None]
        return mu, torch.clamp(var, min=1e-15)
