"""VarDTC -- Titsias' collapsed variational sparse bound, certain inputs.

Counterpart of gpy_tpu/inference/var_dtc.py:29-123 (GPy/inference/
latent_function_inference/var_dtc.py). The bound is one function of the
tensors; autograd replaces the reference's hand-derived dL_dKmm, dL_dpsi and
dL_dR, and gives dF/dZ too. Kmm goes through jitchol_and_inv, whose backward
is matmuls, and the N-sized work through products with its inverse.
Uncertain inputs (the psi statistics) wait for ROADMAP A12,
VarDTC_minibatch for A8.
"""
from __future__ import annotations

import math

import torch

from ..util.linalg import dpotrs, dtrtrs, jitchol, jitchol_and_inv
from .exact import LatentFunctionInference
from .posterior import Posterior

__all__ = ["VarDTC"]

LOG_2_PI = math.log(2 * math.pi)
CONST_JITTER = 1e-6


def _sparse_terms(kern, X, Z, W, Y, qX=None):
    """Shared quantities of the collapsed bound: (L, LB, AAT, c, psi0_sum).
      L  = chol(Kmm + jitter)
      LB = chol(I + L^-1 [sum_n W_n k_n k_n'] L^-T)
      c  = LB^-1 L^-1 (Kmn W Y)
    """
    if qX is not None:
        raise NotImplementedError("VarDTC with uncertain inputs (psi statistics) is not "
                                  "ported yet (ROADMAP A12)")
    M = Z.shape[0]
    eye = torch.eye(M, dtype=Z.dtype, device=Z.device)
    L, Li = jitchol_and_inv(kern.K(Z) + CONST_JITTER * eye)
    Kmn = kern.K(Z, X)  # (M, N)
    # A = Li (Kmn sqrt(W)) before squaring: the N-summed Gram sandwiched
    # between Li's loses gradient precision when Kmm is ill-conditioned
    A = Li @ (Kmn * torch.sqrt(W)[None, :])
    AAT = A @ A.T
    psi1WY = Kmn @ (W[:, None] * Y)
    psi0_sum = torch.sum(W * kern.Kdiag(X))
    LB = jitchol(eye + AAT)
    c = dtrtrs(LB, dtrtrs(L, psi1WY))
    return L, LB, AAT, c, psi0_sum


class VarDTC(LatentFunctionInference):
    """Collapsed variational bound (Titsias 2009), Gaussian likelihood."""

    def _bound(self, kern, X, Z, likelihood, Y, mean_function, Y_metadata, qX):
        """(log marginal bound, L, LB, c)."""
        if mean_function is not None:
            raise NotImplementedError("VarDTC with a mean function: subtract it from Y")
        if not hasattr(likelihood, "noise_diagonal"):
            raise NotImplementedError("VarDTC needs a Gaussian likelihood; sparse "
                                      "classification is not ported yet (ROADMAP A9)")
        N, D = Y.shape
        W = 1.0 / likelihood.noise_diagonal(N, Y_metadata)  # per-point precision
        L, LB, AAT, c, psi0_sum = _sparse_terms(kern, X, Z, W, Y, qX)
        log_marginal = (
            -0.5 * N * D * LOG_2_PI
            + 0.5 * D * torch.sum(torch.log(W))
            - D * torch.sum(torch.log(torch.diagonal(LB)))
            - 0.5 * torch.sum(W[:, None] * Y * Y)
            + 0.5 * torch.sum(c * c)
            - 0.5 * D * (psi0_sum - torch.trace(AAT))
        )
        return log_marginal, L, LB, c

    def inference(self, kern, X, Z, likelihood, Y, mean_function=None, Y_metadata=None,
                  qX=None):
        log_marginal, L, LB, c = self._bound(kern, X, Z, likelihood, Y, mean_function,
                                             Y_metadata, qX)
        return self._posterior(kern, Z, L, LB, c), log_marginal

    def _posterior(self, kern, Z, L, LB, c):
        eye = torch.eye(Z.shape[0], dtype=Z.dtype, device=Z.device)
        # woodbury_vector = L^-T LB^-T c
        wv = dtrtrs(L, dtrtrs(LB, c, trans=True), trans=True)
        # woodbury_inv = L^-T (I - B^-1) L^-1
        tmp = dtrtrs(L, eye - dpotrs(LB, eye), trans=True)
        wi = dtrtrs(L, tmp.T, trans=True).T
        return Posterior(woodbury_vector=wv, woodbury_inv=0.5 * (wi + wi.T), K=kern.K(Z))

    def marginal_likelihood(self, kern, X, Z, likelihood, Y, mean_function=None,
                            Y_metadata=None, qX=None):
        """The bound alone: eager torch would build the posterior that the
        reference's jit drops."""
        return self._bound(kern, X, Z, likelihood, Y, mean_function, Y_metadata, qX)[0]
