"""FITC, DTC and PEP sparse inference.

Counterpart of gpy_tpu/inference/fitc.py:26-131 (GPy/inference/
latent_function_inference/fitc.py, dtc.py, pep.py; Bui/Yan/Turner power EP:
alpha -> 0 is DTC, alpha = 1 FITC). One factorization serves the three:
they differ only in the effective per-point noise and the constant terms.
Kmm goes through jitchol_and_inv, so the (M, N) projection is a product with
its inverse. Autograd replaces the reference's jax.grad; the bound alone
skips the posterior, which the reference's jit drops.
"""
from __future__ import annotations

import math

import torch

from ..util.linalg import dtrtrs, jitchol, jitchol_and_inv
from .exact import LatentFunctionInference
from .posterior import Posterior

__all__ = ["FITC", "DTC", "PEP"]

LOG_2_PI = math.log(2 * math.pi)
CONST_JITTER = 1e-6


def _pep_core(kern, X, Z, likelihood, Y, Y_metadata, alpha, with_posterior=True):
    """(log marginal, posterior or None) of power EP at `alpha` (GPy pep.py:
    28-95). alpha = 0 is DTC: the noise has no diagonal correction and the
    bound no power-EP constant (GPy dtc.py)."""
    M = Z.shape[0]
    N, D = Y.shape
    eye = torch.eye(M, dtype=Z.dtype, device=Z.device)
    sigma_n = likelihood.gaussian_variance(Y_metadata)
    Kmm = kern.K(Z) + CONST_JITTER * eye
    U = kern.K(X, Z)  # (N, M)
    L, Li = jitchol_and_inv(Kmm)
    LiUT = Li @ U.T  # (M, N)
    if alpha > 0.0:
        Qnn = torch.sum(LiUT * LiUT, dim=0)
        beta = 1.0 / (sigma_n + alpha * (kern.Kdiag(X) - Qnn))
    else:
        beta = (1.0 / sigma_n).expand(N)
    LA = jitchol((LiUT * beta[None, :]) @ LiUT.T + eye)
    URiy = U.T @ (beta[:, None] * Y)  # (M, D)
    b = dtrtrs(LA, dtrtrs(L, URiy))
    log_marginal = (
        -0.5 * N * D * LOG_2_PI
        - D * torch.sum(torch.log(torch.diagonal(LA)))
        - 0.5 * torch.sum(beta[:, None] * Y * Y)
        + 0.5 * torch.sum(b * b)
    )
    ac = (1.0 - alpha) / alpha if 0.0 < alpha < 1.0 else 0.0
    log_marginal = log_marginal + 0.5 * D * (1.0 + ac) * torch.sum(torch.log(beta))
    if ac:
        log_marginal = log_marginal + 0.5 * ac * N * torch.log(sigma_n)
    if not with_posterior:
        return log_marginal, None
    v = dtrtrs(L, dtrtrs(LA, b, trans=True), trans=True)  # woodbury_vector
    tmp = dtrtrs(LA, Li)
    # woodbury_inv = Kmm^-1 - (Kmm + U' B U)^-1
    return log_marginal, Posterior(woodbury_vector=v, woodbury_inv=Li.T @ Li - tmp.T @ tmp, K=Kmm)


class _PEPFamily(LatentFunctionInference):
    alpha = 1.0

    def inference(self, kern, X, Z, likelihood, Y, mean_function=None, Y_metadata=None,
                  qX=None):
        self._supported(mean_function, qX)
        lm, post = _pep_core(kern, X, Z, likelihood, Y, Y_metadata, self.alpha)
        return post, lm

    def marginal_likelihood(self, kern, X, Z, likelihood, Y, mean_function=None,
                            Y_metadata=None, qX=None):
        self._supported(mean_function, qX)
        return _pep_core(kern, X, Z, likelihood, Y, Y_metadata, self.alpha,
                         with_posterior=False)[0]

    @staticmethod
    def _supported(mean_function, qX):
        if mean_function is not None:
            raise NotImplementedError("sparse inference with a mean function: subtract it from Y")
        if qX is not None:
            raise ValueError("uncertain inputs need the VarDTC bound")


class FITC(_PEPFamily):
    """Fully independent training conditional (GPy fitc.py:21-86) == PEP(alpha=1)."""

    alpha = 1.0


class DTC(_PEPFamily):
    """Deterministic training conditional (GPy dtc.py): the projected
    process, with neither the trace nor the diagonal correction."""

    alpha = 0.0


class PEP(_PEPFamily):
    """Power-EP sparse regression (GPy pep.py), alpha in (0, 1]."""

    def __init__(self, alpha: float = 0.5):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"PEP needs 0 < alpha <= 1, got {alpha}")
        self.alpha = float(alpha)
