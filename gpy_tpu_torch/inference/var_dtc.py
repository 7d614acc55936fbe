"""VarDTC -- Titsias' collapsed variational sparse bound, with certain or
uncertain inputs -- and VarDTC_minibatch, the same bound accumulated over
row chunks.

Counterpart of gpy_tpu/inference/var_dtc.py:29-210 (GPy/inference/
latent_function_inference/var_dtc.py, var_dtc_parallel.py). The bound is one
function of the tensors; autograd replaces the reference's hand-derived
dL_dKmm, dL_dpsi and dL_dR, and gives dF/dZ and dF/d q(X) too. Kmm goes
through jitchol_and_inv, whose backward is matmuls, and the N-sized work
through products with its inverse. With uncertain inputs (a q(X), the
BayesianGPLVM's bound) the psi statistics take the place of Kdiag, Kmn and
Kmn W Kmn' (kern/psi_comp.py).

Every bound is computed in two stages: `operands` reduces one model's
kernel, inputs and noise to the tensors the bound needs (Kmm, Kmn or the
psi statistics, W), and `_collapsed` factors them. The second stage takes
leading batch dimensions: SparseGP stacks C models' operands (HMC chains,
parallel restarts) and factors the (C, M, M) systems once
(`batched_log_marginal`).
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


def _woodbury(L, LB, c):
    """(woodbury_vector, woodbury_inv) of the collapsed bound:
    L^-T LB^-T c and L^-T (I - B^-1) L^-1, symmetrized. LB and c may carry
    a leading batch dimension (one bound per output, VarDTCMissingData)."""
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    wv = dtrtrs(L, dtrtrs(LB, c, trans=True), trans=True)
    tmp = dtrtrs(L, eye - dpotrs(LB, eye.expand_as(LB)), trans=True)
    wi = dtrtrs(L, tmp.mT, trans=True).mT
    return wv, 0.5 * (wi + wi.mT)


def _precision(likelihood, N, mean_function, Y_metadata):
    """The per-point noise precision W, shape (N,)."""
    if mean_function is not None:
        raise NotImplementedError("VarDTC with a mean function: subtract it from Y")
    if not hasattr(likelihood, "noise_diagonal"):
        raise NotImplementedError("VarDTC needs a Gaussian likelihood; for sparse "
                                  "classification use EPDTC or SparseGPClassification")
    return 1.0 / likelihood.noise_diagonal(N, Y_metadata)


def _certain_operands(kern, X, Z, W, Y):
    """One model's operands with certain inputs: Kmm, Kmn (M, N), W."""
    return {"Kmm": kern.K(Z), "Kmn": kern.K(Z, X), "W": W,
            "psi0_sum": torch.sum(W * kern.Kdiag(X)),
            "YWY": torch.sum(W[:, None] * Y * Y)}


def _psi_operands(kern, Z, W, Y, qX):
    """One model's operands under a q(X): Kmm, psi1' W Y, sum_n W_n psi2_n
    (streamed for an RBF kernel from 512 rows) and sum_n W_n psi0_n."""
    from ..kern.psi_comp import psi2_weighted

    psi1 = kern.psi1(Z, qX)  # (N, M)
    return {"Kmm": kern.K(Z), "psi1WY": psi1.T @ (W[:, None] * Y),
            "Psi2W": psi2_weighted(kern, Z, qX, W), "W": W,
            "psi0_sum": torch.sum(W * kern.psi0(Z, qX)),
            "YWY": torch.sum(W[:, None] * Y * Y)}


def _collapsed(ops, Y):
    """(log marginal bound, L, LB, c) from `operands`, each of which may
    carry one leading batch dimension (C models; Y is shared):
      L  = chol(Kmm + jitter)
      LB = chol(I + L^-1 [sum_n W_n k_n k_n'] L^-T)
      c  = LB^-1 L^-1 (Kmn W Y)
    With Kmn (certain inputs) A = L^-1 Kmn sqrt(W) is formed before
    squaring: the N-summed Gram sandwiched between L^-1's loses gradient
    precision when Kmm is ill-conditioned. The psi statistics and the
    minibatch sums come already squared (Psi2W)."""
    N, D = Y.shape
    Kmm, W = ops["Kmm"], ops["W"]
    eye = torch.eye(Kmm.shape[-1], dtype=Kmm.dtype, device=Kmm.device)
    L, Li = jitchol_and_inv(Kmm + CONST_JITTER * eye)
    if "Kmn" in ops:
        Kmn = ops["Kmn"]
        A = Li @ (Kmn * torch.sqrt(W)[..., None, :])
        AAT = A @ A.mT
        Lpsi1WY = dtrtrs(L, Kmn @ (W[..., :, None] * Y))
    else:
        AAT = Li @ ops["Psi2W"] @ Li.mT
        AAT = 0.5 * (AAT + AAT.mT)
        Lpsi1WY = Li @ ops["psi1WY"]
    LB = jitchol(eye + AAT)
    c = dtrtrs(LB, Lpsi1WY)
    log_marginal = (
        -0.5 * N * D * LOG_2_PI
        + 0.5 * D * torch.sum(torch.log(W), dim=-1)
        - D * torch.sum(torch.log(torch.diagonal(LB, dim1=-2, dim2=-1)), dim=-1)
        - 0.5 * ops["YWY"]
        + 0.5 * torch.sum(c * c, dim=(-2, -1))
        - 0.5 * D * (ops["psi0_sum"] - torch.sum(torch.diagonal(AAT, dim1=-2, dim2=-1), dim=-1))
    )
    return log_marginal, L, LB, c


class VarDTC(LatentFunctionInference):
    """Collapsed variational bound (Titsias 2009), Gaussian likelihood; with
    qX, the uncertain-input bound of the Bayesian GPLVM (before its KL)."""

    def operands(self, kern, X, Z, likelihood, Y, mean_function=None, Y_metadata=None,
                 qX=None):
        """The tensors of one model that the bound factors (`_collapsed`)."""
        W = _precision(likelihood, Y.shape[0], mean_function, Y_metadata)
        if qX is None:
            return _certain_operands(kern, X, Z, W, Y)
        return _psi_operands(kern, Z, W, Y, qX)

    def batched_log_marginal(self, ops, Y):
        """The bounds of C models from their stacked operands ({name: (C,
        ...)}), one batched factorization of the (C, M, M) systems."""
        return _collapsed(ops, Y)[0]

    def _bound(self, kern, X, Z, likelihood, Y, mean_function, Y_metadata, qX):
        """(log marginal bound, L, LB, c)."""
        return _collapsed(self.operands(kern, X, Z, likelihood, Y, mean_function, Y_metadata,
                                        qX), Y)

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
    the larger. Under a q(X) each chunk adds its psi statistics; a
    spike-and-slab q(X) keeps its gamma in the chunks (the reference's
    chunks carry the mean and variance only: ROADMAP C(m)).
    """

    def __init__(self, batchsize: int = 2048):
        self.batchsize = int(batchsize)

    def operands(self, kern, X, Z, likelihood, Y, mean_function=None, Y_metadata=None,
                 qX=None):
        from ..kern.psi_comp import row_slice

        N = Y.shape[0]
        W = _precision(likelihood, N, mean_function, Y_metadata)
        psi0_sum = psi1WY = Psi2W = YWY = 0.0
        for s in range(0, N, self.batchsize):
            e = s + self.batchsize
            w, y = W[s:e], Y[s:e]
            if qX is None:
                xb = X[s:e]
                kmn = kern.K(Z, xb)  # (M, B)
                psi0_sum = psi0_sum + torch.sum(w * kern.Kdiag(xb))
                psi1WY = psi1WY + kmn @ (w[:, None] * y)
                Psi2W = Psi2W + (kmn * w[None, :]) @ kmn.T
            else:
                qb = row_slice(qX, s, e)
                psi0_sum = psi0_sum + torch.sum(w * kern.psi0(Z, qb))
                psi1WY = psi1WY + kern.psi1(Z, qb).T @ (w[:, None] * y)
                Psi2W = Psi2W + torch.einsum("n,nmk->mk", w, kern.psi2n(Z, qb))
            YWY = YWY + torch.sum(w[:, None] * y * y)
        return {"Kmm": kern.K(Z), "psi1WY": psi1WY, "Psi2W": Psi2W, "W": W,
                "psi0_sum": psi0_sum, "YWY": YWY}
