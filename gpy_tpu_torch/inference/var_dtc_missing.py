"""VarDTCMissingData: the collapsed bound with missing entries of Y.

Counterpart of gpy_tpu/inference/var_dtc_missing.py:33-133 (GPy/models/
sparse_gp_minibatch.py, inference/latent_function_inference/vardtc_md.py).
A missing (n, d) entry (NaN in Y) gets the noise precision W_nd = 0, so the
output columns' bounds differ only in their weights. The reference vmaps one
bound over the columns; here they are a batch: Kmn sqrt(W_d) as (D, M, N)
and one batched jitchol of (D, M, M), which stays torch's native batched
Cholesky as the reference's vmapped jitchol stays XLA's. Under a q(X) (the
BayesianGPLVMMiniBatch with missing entries) psi1 takes Kmn's place and each
column's sum_n W_nd psi2_n its squared Gram, from the one (N, M, M) psi2n,
as in the reference.

It has no batched form of its own: SparseGP evaluates C models of it (HMC
chains, parallel restarts) one after the other, each with its D columns
batched.
"""
from __future__ import annotations

import torch

from ..util.linalg import dtrtrs, jitchol, jitchol_and_inv
from .exact import LatentFunctionInference
from .posterior import Posterior
from .var_dtc import CONST_JITTER, LOG_2_PI, _woodbury

__all__ = ["VarDTCMissingData"]


class VarDTCMissingData(LatentFunctionInference):
    def _bound(self, kern, X, Z, likelihood, Y, mean_function, Y_metadata, qX):
        """(summed bound, Kmm, L, LB, c); LB (D, M, M) and c (D, M, 1) hold
        one output column each."""
        if mean_function is not None:
            raise NotImplementedError("VarDTC with a mean function: subtract it from Y")
        M = Z.shape[0]
        obs = ~torch.isnan(Y)  # (N, D)
        Y0 = torch.where(obs, Y, torch.zeros_like(Y))
        mask = obs.to(Y.dtype)
        W = mask / likelihood.gaussian_variance(Y_metadata)  # (N, D)
        eye = torch.eye(M, dtype=Z.dtype, device=Z.device)
        Kmm = kern.K(Z) + CONST_JITTER * eye
        L, Li = jitchol_and_inv(Kmm)
        # the double where keeps the gradients of sqrt and log finite at W = 0
        W_safe = torch.where(obs, W, torch.ones_like(W))
        if qX is None:
            Kmn = kern.K(Z, X)  # (M, N)
            psi0 = kern.Kdiag(X)
            sqrtW = torch.where(obs, torch.sqrt(W_safe), torch.zeros_like(W))
            A = Li @ (Kmn[None] * sqrtW.T[:, None, :])  # (D, M, N)
            AAT = A @ A.mT
        else:
            Kmn = kern.psi1(Z, qX).T
            psi0 = kern.psi0(Z, qX)
            AAT = Li @ torch.einsum("nd,nmk->dmk", W, kern.psi2n(Z, qX)) @ Li.T
            AAT = 0.5 * (AAT + AAT.mT)
        LB = jitchol(eye + AAT)
        psi1WY = Kmn @ (W * Y0)  # (M, D)
        c = dtrtrs(LB, dtrtrs(L, psi1WY).T[:, :, None])
        log_marginal = (
            -0.5 * torch.sum(mask) * LOG_2_PI
            + 0.5 * torch.sum(torch.where(obs, torch.log(W_safe), torch.zeros_like(W)))
            - torch.sum(torch.log(torch.diagonal(LB, dim1=-2, dim2=-1)))
            - 0.5 * torch.sum(W * Y0 * Y0)
            + 0.5 * torch.sum(c * c)
            - 0.5 * (torch.sum(W * psi0[:, None])
                     - torch.sum(torch.diagonal(AAT, dim1=-2, dim2=-1)))
        )
        return log_marginal, Kmm, L, LB, c

    def marginal_likelihood(self, kern, X, Z, likelihood, Y, mean_function=None,
                            Y_metadata=None, qX=None):
        return self._bound(kern, X, Z, likelihood, Y, mean_function, Y_metadata, qX)[0]

    def inference(self, kern, X, Z, likelihood, Y, mean_function=None, Y_metadata=None,
                  qX=None):
        """The posterior's woodbury_inv is the mean of the columns' own, the
        reference's shared-covariance approximation (ROADMAP C(g))."""
        log_marginal, Kmm, L, LB, c = self._bound(kern, X, Z, likelihood, Y, mean_function,
                                                  Y_metadata, qX)
        wv, wi = _woodbury(L, LB, c)
        return Posterior(woodbury_vector=wv[:, :, 0].T, woodbury_inv=torch.mean(wi, dim=0),
                         K=Kmm), log_marginal
