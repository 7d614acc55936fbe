"""SVGP -- the uncollapsed stochastic variational ELBO (Hensman et al. 2013/15).

Counterpart of gpy_tpu/inference/svgp.py:33-236 (GPy/inference/
latent_function_inference/svgp.py). The ELBO is a function of
(q_u_mean, q(u)'s covariance, Z, kern, likelihood); batch_scale rescales the
data term for a minibatch, and autograd gives every gradient, through the
flat-Cholesky packing too. Kmm goes through chol_and_inv, so every solve
against it is a product with its inverse and every backward a matmul.

Three forms of q(u)'s covariance: the flat Cholesky (`svgp_elbo_parts`,
the model's parameters), its (D, M, M) factor (`_L`, the plain training
step) and S itself with its log-determinant carried (`_S`, `_S_white`, the
natural-gradient step, which never factors S).
"""
from __future__ import annotations

import math

import torch

from ..util.choleskies import flat_to_triang
from ..util.linalg import chol_and_inv, dpotrs, jitchol
from .exact import LatentFunctionInference
from .posterior import Posterior

__all__ = ["SVGPInference", "svgp_elbo_parts", "svgp_elbo_parts_L", "svgp_elbo_parts_S",
           "svgp_elbo_parts_S_white", "q_f_marginals", "kl_qu_pu", "q_f_marginals_white",
           "kl_qu_pu_white", "CONST_JITTER"]

LOG_2_PI = math.log(2 * math.pi)
CONST_JITTER = 1e-6


def _kmm_factors(kern, Z):
    """(Kmm, Lmm, Lmm^-1) with Kmm = K(Z) + CONST_JITTER I: the jitter is
    explicit, so one factorization and no ladder."""
    eye = torch.eye(Z.shape[0], dtype=Z.dtype, device=Z.device)
    Kmm = kern.K(Z) + CONST_JITTER * eye
    return (Kmm,) + chol_and_inv(Kmm)


def _diag(A):
    return torch.diagonal(A, dim1=-2, dim2=-1)


def q_f_marginals(kern, X, Z, q_u_mean, L_u):
    """Marginals of q(f) = int p(f|u) q(u) du.

    q_u_mean: (M, D); L_u: (D, M, M) lower Cholesky factor of S.
    Returns (mu (N, D), var (N, D), Lmm, Kmm).
    """
    Kmm, Lmm, Lmi = _kmm_factors(kern, Z)
    Kmn = kern.K(Z, X)  # (M, N)
    C = Lmi @ Kmn  # Lmm^-1 Kmn
    A = Lmi.T @ C  # Kmm^-1 Kmn
    mu = A.T @ q_u_mean
    # var_nd = Kdiag_n - diag(Knm Kmm^-1 Kmn)_n + (A' S_d A)_nn
    AKmn = torch.sum(C * C, dim=0)
    SA = torch.einsum("dij,jn->din", L_u.transpose(1, 2), A)  # L' A, (D, M, N)
    ASA = torch.sum(SA**2, dim=1).T
    var = (kern.Kdiag(X) - AKmn)[:, None] + ASA
    return mu, torch.clamp(var, min=1e-12), Lmm, Kmm


def kl_qu_pu(q_u_mean, L_u, Lmm):
    """KL(q(u) || p(u)) summed over outputs; q(u) = N(m, LL'), p(u) = N(0, Kmm)."""
    M = L_u.shape[-1]
    D = q_u_mean.shape[1]
    Li_m = torch.linalg.solve_triangular(Lmm, q_u_mean, upper=False)
    V = torch.linalg.solve_triangular(Lmm, L_u, upper=False)  # per output
    logdet_K = 2.0 * torch.sum(torch.log(_diag(Lmm)))
    logdet_S = 2.0 * torch.sum(torch.log(torch.abs(_diag(L_u))))
    return 0.5 * (torch.sum(V * V) + torch.sum(Li_m**2) - M * D + D * logdet_K - logdet_S)


def q_f_marginals_white(kern, X, Z, v_m, L_w):
    """Marginals of q(f) for the whitened q(u) = N(Lmm v, Lmm S_w Lmm').

    v_m: (M, D) whitened mean; L_w: (D, M, M) lower factor of S_w. With
    C = Lmm^-1 Kmn: mu = C' v, var = Kdiag - diag(C'C) + diag(C' S_w C).
    """
    Kmm, Lmm, Lmi = _kmm_factors(kern, Z)
    C = Lmi @ kern.K(Z, X)
    mu = C.T @ v_m
    CKC = torch.sum(C * C, dim=0)
    LC = torch.einsum("dji,jn->din", L_w, C)  # L_w' C, (D, M, N)
    CSC = torch.sum(LC**2, dim=1).T
    var = (kern.Kdiag(X) - CKC)[:, None] + CSC
    return mu, torch.clamp(var, min=1e-12), Lmm, Kmm


def kl_qu_pu_white(v_m, L_w):
    """KL(N(v, L_w L_w') || N(0, I)) summed over outputs: no solve."""
    M = L_w.shape[-1]
    D = v_m.shape[1]
    logdet_S = 2.0 * torch.sum(torch.log(torch.abs(_diag(L_w))))
    return 0.5 * (torch.sum(L_w**2) + torch.sum(v_m**2) - M * D - logdet_S)


def svgp_elbo_parts_L(kern, X, Z, likelihood, Y, q_u_mean, L_u, Y_metadata=None,
                      batch_scale=1.0, mean_function=None):
    """(datafit_sum * batch_scale, KL) with q(u)'s (D, M, M) lower factor."""
    if mean_function is not None:
        raise NotImplementedError("mean functions are not ported yet (ROADMAP A17)")
    mu, var, Lmm, _ = q_f_marginals(kern, X, Z, q_u_mean, L_u)
    F = likelihood.variational_expectations(Y, mu, var, Y_metadata)
    return torch.sum(F) * batch_scale, kl_qu_pu(q_u_mean, L_u, Lmm)


def svgp_elbo_parts(kern, X, Z, likelihood, Y, q_u_mean, q_u_chol_flat, Y_metadata=None,
                    batch_scale=1.0, mean_function=None):
    """(datafit_sum * batch_scale, KL); ELBO = the first minus the second."""
    L_u = flat_to_triang(q_u_chol_flat, Z.shape[0])
    return svgp_elbo_parts_L(kern, X, Z, likelihood, Y, q_u_mean, L_u, Y_metadata,
                             batch_scale, mean_function)


def _data_term(kern, X, likelihood, Y, C, mu, var_extra, Y_metadata, batch_scale):
    var = torch.clamp((kern.Kdiag(X) - torch.sum(C * C, dim=0))[:, None] + var_extra, min=1e-12)
    return torch.sum(likelihood.variational_expectations(Y, mu, var, Y_metadata)) * batch_scale


def svgp_elbo_parts_S(kern, X, Z, likelihood, Y, q_u_mean, S, logdet_S, Y_metadata=None,
                      batch_scale=1.0, mean_function=None):
    """ELBO parts in closed form in the covariance S, with no factor of S.

    S enters through diag(A' S A), tr(Kmm^-1 S) and logdet S; the first two
    are products and the last is carried by the natural-gradient step. The
    entropy's gradient (+0.5 S^-1, from the logdet passed in as a constant)
    is the caller's to add. S: (D, M, M) symmetric PD; logdet_S: the sum
    over outputs.
    """
    if mean_function is not None:
        raise NotImplementedError("mean functions are not ported yet (ROADMAP A17)")
    M = Z.shape[0]
    D = Y.shape[1]
    _, Lmm, Lmi = _kmm_factors(kern, Z)
    C = Lmi @ kern.K(Z, X)  # whitened cross-covariance (M, N)
    Li_m = Lmi @ q_u_mean
    # W = Lmm^-1 S Lmm^-T per output: diag(A'SA) = diag(C' W C)
    W = torch.einsum("ij,djk,lk->dil", Lmi, S, Lmi)
    WC = torch.einsum("dij,jn->din", W, C)
    CWC = torch.sum(C[None] * WC, dim=1).T
    datafit = _data_term(kern, X, likelihood, Y, C, C.T @ Li_m, CWC, Y_metadata, batch_scale)
    # KL(q||p) = 0.5 (tr(Kmm^-1 S) + m' Kmm^-1 m - MD + D logdet K - logdet S)
    logdet_K = 2.0 * torch.sum(torch.log(_diag(Lmm)))
    kl = 0.5 * (torch.sum(_diag(W)) + torch.sum(Li_m**2) - M * D + D * logdet_K - logdet_S)
    return datafit, kl


def svgp_elbo_parts_S_white(kern, X, Z, likelihood, Y, v_m, S_w, logdet_Sw, Y_metadata=None,
                            batch_scale=1.0, mean_function=None):
    """Whitened ELBO parts, q(u) = N(Lmm v_m, Lmm S_w Lmm'): the KL needs no
    solve and S_w is the middle factor itself. The same contract as
    svgp_elbo_parts_S for the entropy's gradient."""
    if mean_function is not None:
        raise NotImplementedError("mean functions are not ported yet (ROADMAP A17)")
    M = Z.shape[0]
    D = Y.shape[1]
    _, _, Lmi = _kmm_factors(kern, Z)
    C = Lmi @ kern.K(Z, X)
    SC = torch.einsum("dij,jn->din", S_w, C)
    CSC = torch.sum(C[None] * SC, dim=1).T
    datafit = _data_term(kern, X, likelihood, Y, C, C.T @ v_m, CSC, Y_metadata, batch_scale)
    kl = 0.5 * (torch.sum(_diag(S_w)) + torch.sum(v_m**2) - M * D - logdet_Sw)
    return datafit, kl


class SVGPInference(LatentFunctionInference):
    """ELBO evaluation and the posterior container of the SVGP model."""

    def posterior(self, kern, Z, q_u_mean, q_u_chol_flat) -> Posterior:
        """mean = Kxm Kmm^-1 m, so wv = Kmm^-1 m; cov = Kxx - Kxm [Kmm^-1 -
        Kmm^-1 S Kmm^-1] Kmx, with the first output's S (as the reference)."""
        M = Z.shape[0]
        L_u = flat_to_triang(q_u_chol_flat, M)
        eye = torch.eye(M, dtype=Z.dtype, device=Z.device)
        Kmm = kern.K(Z) + CONST_JITTER * eye
        Lmm = jitchol(Kmm)
        S = L_u[0] @ L_u[0].T
        wi = dpotrs(Lmm, eye) - dpotrs(Lmm, dpotrs(Lmm, S).T)
        return Posterior(woodbury_vector=dpotrs(Lmm, q_u_mean), woodbury_inv=0.5 * (wi + wi.T),
                         K=Kmm)

    def inference(self, kern, X, Z, likelihood, Y, q_u_mean, q_u_chol_flat, Y_metadata=None,
                  batch_scale=1.0, mean_function=None):
        datafit, kl = svgp_elbo_parts(kern, X, Z, likelihood, Y, q_u_mean, q_u_chol_flat,
                                      Y_metadata, batch_scale, mean_function)
        return self.posterior(kern, Z, q_u_mean, q_u_chol_flat), datafit - kl
