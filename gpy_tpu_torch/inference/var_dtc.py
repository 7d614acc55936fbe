"""VarDTC -- Titsias' collapsed variational sparse bound, certain inputs --
and VarDTC_minibatch, the same bound accumulated over row chunks.

Counterpart of gpy_tpu/inference/var_dtc.py:29-210 (GPy/inference/
latent_function_inference/var_dtc.py, var_dtc_parallel.py). The bound is one
function of the tensors; autograd replaces the reference's hand-derived
dL_dKmm, dL_dpsi and dL_dR, and gives dF/dZ too. Kmm goes through
jitchol_and_inv, whose backward is matmuls, and the N-sized work through
products with its inverse. Uncertain inputs (the psi statistics) wait for
ROADMAP A12.
"""
from __future__ import annotations

import math

import torch

from ..util.linalg import dpotrs, dtrtrs, jitchol, jitchol_and_inv
from .exact import LatentFunctionInference
from .posterior import Posterior

__all__ = ["VarDTC", "VarDTC_minibatch"]

LOG_2_PI = math.log(2 * math.pi)
CONST_JITTER = 1e-6


def _certain_inputs(qX):
    if qX is not None:
        raise NotImplementedError("VarDTC with uncertain inputs (psi statistics) is not "
                                  "ported yet (ROADMAP A12)")


def _woodbury(L, LB, c):
    """(woodbury_vector, woodbury_inv) of the collapsed bound:
    L^-T LB^-T c and L^-T (I - B^-1) L^-1, symmetrized. LB and c may carry
    a leading batch dimension (one bound per output, VarDTCMissingData)."""
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    wv = dtrtrs(L, dtrtrs(LB, c, trans=True), trans=True)
    tmp = dtrtrs(L, eye - dpotrs(LB, eye.expand_as(LB)), trans=True)
    wi = dtrtrs(L, tmp.mT, trans=True).mT
    return wv, 0.5 * (wi + wi.mT)


def _sparse_terms(kern, X, Z, W, Y, qX=None):
    """Shared quantities of the collapsed bound: (L, LB, AAT, c, psi0_sum).
      L  = chol(Kmm + jitter)
      LB = chol(I + L^-1 [sum_n W_n k_n k_n'] L^-T)
      c  = LB^-1 L^-1 (Kmn W Y)
    """
    _certain_inputs(qX)
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


def _precision(likelihood, N, mean_function, Y_metadata):
    """The per-point noise precision W, shape (N,)."""
    if mean_function is not None:
        raise NotImplementedError("VarDTC with a mean function: subtract it from Y")
    if not hasattr(likelihood, "noise_diagonal"):
        raise NotImplementedError("VarDTC needs a Gaussian likelihood; for sparse "
                                  "classification use EPDTC or SparseGPClassification")
    return 1.0 / likelihood.noise_diagonal(N, Y_metadata)


def _log_marginal(N, D, W, LB, YWY, c, psi0_sum, AAT):
    return (
        -0.5 * N * D * LOG_2_PI
        + 0.5 * D * torch.sum(torch.log(W))
        - D * torch.sum(torch.log(torch.diagonal(LB)))
        - 0.5 * YWY
        + 0.5 * torch.sum(c * c)
        - 0.5 * D * (psi0_sum - torch.trace(AAT))
    )


class VarDTC(LatentFunctionInference):
    """Collapsed variational bound (Titsias 2009), Gaussian likelihood."""

    def _bound(self, kern, X, Z, likelihood, Y, mean_function, Y_metadata, qX):
        """(log marginal bound, L, LB, c)."""
        N, D = Y.shape
        W = _precision(likelihood, N, mean_function, Y_metadata)
        L, LB, AAT, c, psi0_sum = _sparse_terms(kern, X, Z, W, Y, qX)
        YWY = torch.sum(W[:, None] * Y * Y)
        return _log_marginal(N, D, W, LB, YWY, c, psi0_sum, AAT), L, LB, c

    def inference(self, kern, X, Z, likelihood, Y, mean_function=None, Y_metadata=None,
                  qX=None):
        log_marginal, L, LB, c = self._bound(kern, X, Z, likelihood, Y, mean_function,
                                             Y_metadata, qX)
        return self._posterior(kern, Z, L, LB, c), log_marginal

    def _posterior(self, kern, Z, L, LB, c):
        wv, wi = _woodbury(L, LB, c)
        return Posterior(woodbury_vector=wv, woodbury_inv=wi, K=kern.K(Z))

    def marginal_likelihood(self, kern, X, Z, likelihood, Y, mean_function=None,
                            Y_metadata=None, qX=None):
        """The bound alone: eager torch would build the posterior that the
        reference's jit drops."""
        return self._bound(kern, X, Z, likelihood, Y, mean_function, Y_metadata, qX)[0]


class VarDTC_minibatch(VarDTC):
    """The collapsed bound with the rows streamed in chunks of `batchsize`.

    Reference: gpy_tpu/inference/var_dtc.py:124-210 (GPy var_dtc_parallel.py:
    72-230). The reference's lax.scan over zero-padded chunks is a loop over
    row slices here; a short last slice gives the sums the padding does.
    Each chunk adds its share of psi0, psi1' W Y, Psi2W = sum_n W_n k_n k_n'
    and Y' W Y: one Gram launch a chunk, one more for Kmm. Streaming forces
    the squared Gram Psi2W, sandwiched between Kmm's inverse factors
    afterwards, which VarDTC's unsquared form avoids: its float32 error is
    the larger.
    """

    def __init__(self, batchsize: int = 2048):
        self.batchsize = int(batchsize)

    def _bound(self, kern, X, Z, likelihood, Y, mean_function, Y_metadata, qX):
        _certain_inputs(qX)
        N, D = Y.shape
        M = Z.shape[0]
        W = _precision(likelihood, N, mean_function, Y_metadata)
        psi0_sum = psi1WY = Psi2W = YWY = 0.0
        for s in range(0, N, self.batchsize):
            w, y, xb = W[s:s + self.batchsize], Y[s:s + self.batchsize], X[s:s + self.batchsize]
            kmn = kern.K(Z, xb)  # (M, B)
            psi0_sum = psi0_sum + torch.sum(w * kern.Kdiag(xb))
            psi1WY = psi1WY + kmn @ (w[:, None] * y)
            Psi2W = Psi2W + (kmn * w[None, :]) @ kmn.T
            YWY = YWY + torch.sum(w[:, None] * y * y)
        eye = torch.eye(M, dtype=Z.dtype, device=Z.device)
        L, Li = jitchol_and_inv(kern.K(Z) + CONST_JITTER * eye)
        AAT = Li @ Psi2W @ Li.T
        AAT = 0.5 * (AAT + AAT.T)
        LB = jitchol(eye + AAT)
        c = dtrtrs(LB, Li @ psi1WY)
        return _log_marginal(N, D, W, LB, YWY, c, psi0_sum, AAT), L, LB, c
