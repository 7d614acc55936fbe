"""Opper-Archambeau variational Gaussian approximation.

Counterpart of gpy_tpu/inference/var_gauss.py:19-50 (GPy/inference/
latent_function_inference/var_gauss.py:9-69). q(f) = N(K alpha, (K^-1 +
diag(lam))^-1) with per-point variational parameters (alpha, lam), for any
likelihood: its expected log density is the likelihood's
variational_expectations (Gauss-Hermite, or a closed form). There is no
batched form (no `noisy_gram`): GP evaluates batched rows one after the
other.
"""
from __future__ import annotations

import torch

from ..util.linalg import jitchol
from .exact import LatentFunctionInference
from .posterior import Posterior

__all__ = ["VarGauss"]


def _factors(kern, X, lam):
    """(K + 1e-8 I, sqrt(lam), the Cholesky factor of A = I + sl K sl)."""
    N = X.shape[0]
    eye = torch.eye(N, dtype=X.dtype, device=X.device)
    K = kern.K(X) + 1e-8 * eye
    sl = torch.sqrt(lam)
    return K, sl, jitchol(eye + (sl * K) * sl.T)


def _elbo(K, sl, LA, likelihood, Y, alpha, lam, Y_metadata):
    m = K @ alpha
    # diag of Sigma = K - K sl A^-1 sl K
    V = torch.linalg.solve_triangular(LA, sl * K, upper=False)
    diag_Sigma = torch.clamp(torch.diagonal(K) - torch.sum(V * V, dim=0), min=1e-12)
    F = likelihood.variational_expectations(Y, m, diag_Sigma[:, None], Y_metadata)
    # KL(q || p) = 1/2 (alpha' K alpha + logdet(A) - tr(Lam Sigma))
    kl = 0.5 * (torch.sum(alpha * m) + 2.0 * torch.sum(torch.log(torch.diagonal(LA)))
                - torch.sum(lam[:, 0] * diag_Sigma))
    return torch.sum(F) - kl


class VarGauss(LatentFunctionInference):
    def elbo(self, kern, X, likelihood, Y, alpha, lam, Y_metadata=None):
        """sum_n E_q[log p(y_n | f_n)] - KL(q || p); alpha (N, 1), lam (N, 1)
        positive."""
        return _elbo(*_factors(kern, X, lam), likelihood, Y, alpha, lam, Y_metadata)

    def inference(self, kern, X, likelihood, Y, alpha, lam, Y_metadata=None):
        """(Posterior with woodbury vector alpha and woodbury inverse
        sl A^-1 sl, the ELBO)."""
        K, sl, LA = _factors(kern, X, lam)
        Ai = torch.cholesky_inverse(LA)
        post = Posterior(woodbury_vector=alpha, woodbury_inv=(sl * Ai) * sl.T, K=K)
        return post, _elbo(K, sl, LA, likelihood, Y, alpha, lam, Y_metadata)
