"""FITC, DTC and PEP sparse inference.

Counterpart of gpy_tpu/inference/fitc.py:26-131 (GPy/inference/
latent_function_inference/fitc.py, dtc.py, pep.py; Bui/Yan/Turner power EP:
alpha -> 0 is DTC, alpha = 1 FITC). One factorization serves the three:
they differ only in the effective per-point noise and the constant terms.
Kmm goes through jitchol_and_inv, so the (M, N) projection is a product with
its inverse. Autograd replaces the reference's jax.grad; the bound alone
skips the posterior, which the reference's jit drops. The bound is computed
from one model's operands (Kmm, Knm, Kdiag, the noise), which SparseGP may
stack for C models and factor at once (HMC chains, parallel restarts).
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


def _pep_operands(kern, X, Z, likelihood, Y_metadata):
    """One model's operands: Kmm, U = Knm, Kdiag and the noise variance."""
    return {"Kmm": kern.K(Z), "U": kern.K(X, Z), "Kdiag": kern.Kdiag(X),
            "sigma_n": likelihood.gaussian_variance(Y_metadata)}


def _pep_core(ops, Y, alpha, with_posterior=True):
    """(log marginal, posterior or None) of power EP at `alpha` (GPy pep.py:
    28-95) from `_pep_operands`. alpha = 0 is DTC: the noise has no diagonal
    correction and the bound no power-EP constant (GPy dtc.py). Without the
    posterior the operands may carry a leading batch dimension (C models
    of one Y, factored at once)."""
    Kmm, U, sigma_n = ops["Kmm"], ops["U"], ops["sigma_n"]
    M = Kmm.shape[-1]
    N, D = Y.shape
    eye = torch.eye(M, dtype=Kmm.dtype, device=Kmm.device)
    L, Li = jitchol_and_inv(Kmm + CONST_JITTER * eye)
    LiUT = Li @ U.mT  # (M, N)
    # a noise variance per model (scalar) broadcasts over the rows
    sn = sigma_n[..., None] if sigma_n.ndim == U.ndim - 2 else sigma_n
    if alpha > 0.0:
        Qnn = torch.sum(LiUT * LiUT, dim=-2)
        beta = 1.0 / (sn + alpha * (ops["Kdiag"] - Qnn))
    else:
        beta = (1.0 / sn).expand(*U.shape[:-1])
    LA = jitchol((LiUT * beta[..., None, :]) @ LiUT.mT + eye)
    URiy = U.mT @ (beta[..., :, None] * Y)  # (M, D)
    b = dtrtrs(LA, dtrtrs(L, URiy))
    log_marginal = (
        -0.5 * N * D * LOG_2_PI
        - D * torch.sum(torch.log(torch.diagonal(LA, dim1=-2, dim2=-1)), dim=-1)
        - 0.5 * torch.sum(beta[..., :, None] * Y * Y, dim=(-2, -1))
        + 0.5 * torch.sum(b * b, dim=(-2, -1))
    )
    ac = (1.0 - alpha) / alpha if 0.0 < alpha < 1.0 else 0.0
    log_marginal = log_marginal + 0.5 * D * (1.0 + ac) * torch.sum(torch.log(beta), dim=-1)
    if ac:
        log_marginal = log_marginal + 0.5 * ac * N * torch.log(sigma_n)
    if not with_posterior:
        return log_marginal, None
    v = dtrtrs(L, dtrtrs(LA, b, trans=True), trans=True)  # woodbury_vector
    tmp = dtrtrs(LA, Li)
    # woodbury_inv = Kmm^-1 - (Kmm + U' B U)^-1
    return log_marginal, Posterior(woodbury_vector=v, woodbury_inv=Li.T @ Li - tmp.T @ tmp,
                                   K=Kmm + CONST_JITTER * eye)


class _PEPFamily(LatentFunctionInference):
    alpha = 1.0

    def inference(self, kern, X, Z, likelihood, Y, mean_function=None, Y_metadata=None,
                  qX=None):
        self._supported(mean_function, qX)
        lm, post = _pep_core(_pep_operands(kern, X, Z, likelihood, Y_metadata), Y, self.alpha)
        return post, lm

    def marginal_likelihood(self, kern, X, Z, likelihood, Y, mean_function=None,
                            Y_metadata=None, qX=None):
        self._supported(mean_function, qX)
        return _pep_core(_pep_operands(kern, X, Z, likelihood, Y_metadata), Y, self.alpha,
                         with_posterior=False)[0]

    def operands(self, kern, X, Z, likelihood, Y, mean_function=None, Y_metadata=None,
                 qX=None):
        """The tensors of one model that the bound factors."""
        self._supported(mean_function, qX)
        return _pep_operands(kern, X, Z, likelihood, Y_metadata)

    def batched_log_marginal(self, ops, Y):
        """The bounds of C models from their stacked operands ({name: (C,
        ...)}), one batched factorization of the (C, M, M) systems."""
        return _pep_core(ops, Y, self.alpha, with_posterior=False)[0]

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
