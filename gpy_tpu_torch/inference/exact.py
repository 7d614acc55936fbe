"""Exact Gaussian inference (GP regression).

Counterpart of gpy_tpu/inference/exact.py:33-180 (GPy/inference/
latent_function_inference/exact_gaussian_inference.py:37-88): one Cholesky of
K + diag(noise); autograd through it gives GPy's closed-form gradient.
ExactStudentTInference waits.
"""
from __future__ import annotations

import math

import torch

from ..util.linalg import dpotri, dpotrs, jitchol, jitchol_and_inv, logdet_from_chol
from .posterior import Posterior

__all__ = ["ExactGaussianInference", "LatentFunctionInference", "EXPLICIT_INV_MAX_N"]

LOG_2_PI = math.log(2 * math.pi)


def _t(X: torch.Tensor) -> torch.Tensor:
    return X.transpose(-1, -2)

# Up to this N the NLML goes through the explicit inverse (_ExactInvTerms,
# whose backward is one matmul); above it through chol/dpotrs and autograd.
# The value is the reference's (gpy_tpu/inference/exact.py:121), measured on
# a TPU; it has not been re-measured on the card.
EXPLICIT_INV_MAX_N = 1024


class _ExactInvTerms(torch.autograd.Function):
    """(quad, logdet, L, alpha) for the explicit-inverse exact-GP path.

    The backward applies GPy's closed form dL/dK = 0.5 (alpha alpha' - K^-1)
    directly, with K^-1 = Li' Li as its one O(n^3) product. Gradients of
    outputs nobody used arrive as None (materialize_grads off), as
    SymbolicZero does in the reference, and their terms are skipped.
    Ky may carry leading batch dimensions (C models, one batched
    factorization); quad and logdet then have that shape, and a YY shared
    by the batch is broadcast.
    """

    @staticmethod
    def forward(ctx, Ky, YY):
        ctx.set_materialize_grads(False)
        L, Li = jitchol_and_inv(Ky)
        t = Li @ YY
        alpha = _t(Li) @ t
        quad = torch.sum(t * t, dim=(-2, -1))
        logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)
        ctx.yy_shape = YY.shape
        ctx.save_for_backward(L, Li, alpha)
        return quad, logdet, L, alpha

    @staticmethod
    def backward(ctx, g_quad, g_logdet, g_L, g_alpha):
        L, Li, alpha = ctx.saved_tensors
        LiT = _t(Li)
        Ky_bar = None
        YY_bar = None

        def acc(a, b):
            return b if a is None else a + b

        sym = True  # every contribution so far is symmetric
        if g_quad is not None:
            g = g_quad[..., None, None]
            Ky_bar = acc(Ky_bar, -g * (alpha @ _t(alpha)))
            YY_bar = acc(YY_bar, 2.0 * g * alpha)
        if g_logdet is not None:
            Ky_bar = acc(Ky_bar, g_logdet[..., None, None] * (LiT @ Li))
        if g_alpha is not None:
            w = LiT @ (Li @ g_alpha)  # K^-1 g_alpha
            Ky_bar = acc(Ky_bar, -(w @ _t(alpha)))
            YY_bar = acc(YY_bar, w)
            sym = False
        if g_L is not None:
            # Cholesky pullback in matmul form (util/linalg._CholAndInv)
            P = torch.tril(_t(L) @ g_L)
            P = P - 0.5 * torch.diag_embed(torch.diagonal(P, dim1=-2, dim2=-1))
            Ky_bar = acc(Ky_bar, LiT @ P @ Li)
            sym = False
        if Ky_bar is None:
            Ky_bar = torch.zeros_like(L)
        if YY_bar is None:
            YY_bar = torch.zeros_like(alpha)
        if not sym:
            Ky_bar = 0.5 * (Ky_bar + _t(Ky_bar))
        # a YY shared by a batch of Ky gets the sum of the batch's cotangents
        YY_bar = YY_bar.sum_to_size(ctx.yy_shape)
        return Ky_bar, YY_bar


class LatentFunctionInference:
    def inference(self, kern, X, likelihood, Y, mean_function=None, Y_metadata=None):
        raise NotImplementedError

    def marginal_likelihood(self, kern, X, likelihood, Y, mean_function=None, Y_metadata=None):
        return self.inference(kern, X, likelihood, Y, mean_function, Y_metadata)[1]

    # hooks GP.optimize calls around every optimizer run (EP's alternated mode)
    def on_optimization_start(self):
        pass

    def on_optimization_end(self):
        pass

    # --- the batched form: C models of one data set, one factorization ----
    # An inference with one defines noisy_gram(kern, X, likelihood,
    # Y_metadata) -> K + diag(noise) of one model, the operand that
    # batched_log_marginal(Kys, Y) takes stacked as (C, N, N). GP evaluates
    # the rows of an inference without it one after the other.


def _noisy(K, likelihood, Y_metadata=None):
    # the 1e-8 floor keeps a zero-noise model factorizable (reference :150)
    noise = likelihood.noise_diagonal(K.shape[-1], Y_metadata) + 1e-8
    return K + torch.diag(noise)


def _exact_terms(Ky, YY):
    """(quad, logdet, L, alpha) of Ky (leading batch dims allowed): the
    explicit inverse up to EXPLICIT_INV_MAX_N, else jitchol and dpotrs."""
    if YY.shape[-2] <= EXPLICIT_INV_MAX_N:
        return _ExactInvTerms.apply(Ky, YY)
    L = jitchol(Ky)
    alpha = dpotrs(L, YY.expand(*Ky.shape[:-2], *YY.shape))
    return torch.sum(alpha * YY, dim=(-2, -1)), logdet_from_chol(L), L, alpha


class ExactGaussianInference(LatentFunctionInference):
    """Closed-form GP regression posterior + marginal likelihood."""

    def inference(self, kern, X, likelihood, Y, mean_function=None, Y_metadata=None):
        N = X.shape[0]
        D = Y.shape[1]
        YY = Y - mean_function.f(X) if mean_function is not None else Y
        K = kern.K(X)
        quad, logdet, L, alpha = _exact_terms(_noisy(K, likelihood, Y_metadata), YY)
        log_marginal = -0.5 * (D * N * LOG_2_PI + D * logdet + quad)
        return Posterior(woodbury_chol=L, woodbury_vector=alpha, K=K), log_marginal

    def noisy_gram(self, kern, X, likelihood, Y_metadata=None):
        return _noisy(kern.K(X), likelihood, Y_metadata)

    def batched_log_marginal(self, Kys, Y):
        """The reference's exact NLML under jax.vmap (gpy_tpu/inference/
        exact.py:144-163 with a batched Ky): up to EXPLICIT_INV_MAX_N one
        batched jitchol_and_inv (the blocked Cholesky above n = 256),
        above it a batched jitchol; the jitter ladder runs per model."""
        N, D = Y.shape
        quad, logdet, _, _ = _exact_terms(Kys, Y)
        return -0.5 * (D * N * LOG_2_PI + D * logdet + quad)

    def LOO(self, kern, X, likelihood, Y, mean_function=None, Y_metadata=None):
        """Leave-one-out predictive log densities. GPy: exact_gaussian_inference.py:76-88."""
        YY = Y - mean_function.f(X) if mean_function is not None else Y
        L = jitchol(_noisy(kern.K(X), likelihood, Y_metadata))
        Ki = dpotri(L)
        alpha = dpotrs(L, YY)
        diag_Ki = torch.diagonal(Ki)[:, None]
        mu_loo = Y - alpha / diag_Ki
        var_loo = 1.0 / diag_Ki
        return -0.5 * torch.log(2 * math.pi * var_loo) - 0.5 * (Y - mu_loo) ** 2 / var_loo
