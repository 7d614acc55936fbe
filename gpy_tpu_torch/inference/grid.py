"""Kronecker/grid Gaussian inference (Saatci 2011).

Counterpart of gpy_tpu/inference/grid.py:1-59 (GPy/inference/
latent_function_inference/gaussian_grid_inference.py, grid_posterior.py).
With K = kron_d K_d + sigma2 I over a tensor grid, one `torch.linalg.eigh`
per axis (cuSOLVER on the card) and tensor rotations give the log marginal
in O(sum n_d^3 + N sum n_d).

The gradient does not differentiate the eigenvectors. The reference
differentiates through `eigh`, whose derivative divides by differences of
eigenvalues; an RBF Gram on dozens of evenly spaced points has many at
rounding level, and its gradient is then wrong (ROADMAP C(w)). Here the
log marginal is one autograd Function whose backward is GPy's hand-derived
form: with alpha = (K + sigma2 I)^-1 y as a grid tensor, S = kron S_d +
sigma2, and beta_d = alpha rotated by K_e along every axis e != d,

    dL/dK_d    = -1/2 Q_d diag(w_d) Q_d' + 1/2 unfold_d(alpha) unfold_d(beta_d)',
    w_d[i]     = sum over the other axes of prod_{e != d} S_e / S,
    dL/dsigma2 = -1/2 (sum 1/S - sum alpha^2),

and autograd carries dL/dK_d into each axis kernel's K (B1's backward for
an RBF).
"""
from __future__ import annotations

import math

import torch

__all__ = ["GaussianGridInference", "GridPosterior", "rotate_all", "rotate_axis"]

LOG_2_PI = math.log(2 * math.pi)


def rotate_axis(T: torch.Tensor, M: torch.Tensor, d: int) -> torch.Tensor:
    """M applied along axis d of the grid tensor T: (M @ unfold_d(T)) folded
    back, M of shape (m, n_d)."""
    return torch.movedim(torch.tensordot(M, torch.movedim(T, d, 0), dims=1), 0, d)


def rotate_all(T: torch.Tensor, Qs, transpose: bool = True) -> torch.Tensor:
    """Q_d' (or Q_d) applied along each axis d of the grid tensor."""
    for d, Q in enumerate(Qs):
        T = rotate_axis(T, Q.T if transpose else Q, d)
    return T


def _axis_product(Ss, skip=None) -> torch.Tensor:
    """The grid tensor of prod_d S_d[k_d] (axis `skip` left out, with size
    1 there)."""
    D = len(Ss)
    out = None
    for d, Sd in enumerate(Ss):
        f = torch.ones_like(Sd[:1]) if d == skip else Sd
        f = f.reshape([1] * d + [-1] + [1] * (D - d - 1))
        out = f if out is None else out * f
    return out


def _grid_factors(Ks, sigma2, Y):
    """(Qs, Ss, S, alpha, log marginal) of kron_d K_d + sigma2 I and the grid
    tensor Y, with no graph."""
    eigs = [torch.linalg.eigh(K) for K in Ks]
    Ss = [e.eigenvalues for e in eigs]
    Qs = [e.eigenvectors for e in eigs]
    Ytil = rotate_all(Y, Qs, transpose=True)
    S = _axis_product(Ss) + sigma2
    N = Y.numel()
    # the reference's floor; in float32 1e-300 rounds to 0 in both packages
    log_marginal = -0.5 * (N * LOG_2_PI + torch.sum(torch.log(torch.clamp(S, min=1e-300)))
                           + torch.sum(Ytil * Ytil / S))
    alpha = rotate_all(Ytil / S, Qs, transpose=False)
    return Qs, Ss, S, alpha, log_marginal


class _GridLogMarginal(torch.autograd.Function):
    """log N(vec Y; 0, kron_d K_d + sigma2 I) with GPy's hand-derived
    gradient (module docstring). Inputs (Y, sigma2, K_1, ..., K_D); Y gets
    no gradient. Also returns alpha, S and the eigenvectors, for the
    posterior, as outputs without gradient."""

    @staticmethod
    def forward(ctx, Y, sigma2, *Ks):
        Qs, Ss, S, alpha, lm = _grid_factors(Ks, sigma2, Y)
        ctx.save_for_backward(S, alpha, *Ks, *Qs, *Ss)
        ctx.n_axes = len(Ks)
        ctx.mark_non_differentiable(S, alpha, *Qs, *Ss)
        return (lm, S, alpha, *Qs, *Ss)

    @staticmethod
    def backward(ctx, g, *unused):
        D = ctx.n_axes
        saved = ctx.saved_tensors
        S, alpha = saved[0], saved[1]
        Ks, Qs, Ss = saved[2:2 + D], saved[2 + D:2 + 2 * D], saved[2 + 2 * D:]
        grads = [None, None]
        if ctx.needs_input_grad[1]:
            grads[1] = -0.5 * g * (torch.sum(1.0 / S) - torch.sum(alpha * alpha))
        for d in range(D):
            if not ctx.needs_input_grad[2 + d]:
                grads.append(None)
                continue
            others = [e for e in range(D) if e != d]
            w = _axis_product(Ss, skip=d) / S
            if others:  # torch.sum over no dimension would sum them all
                w = torch.sum(w, dim=others)
            beta = alpha
            for e in others:
                beta = rotate_axis(beta, Ks[e], e)
            a = torch.movedim(alpha, d, 0).reshape(alpha.shape[d], -1)
            b = torch.movedim(beta, d, 0).reshape(alpha.shape[d], -1)
            dK = -0.5 * (Qs[d] * w) @ Qs[d].T + 0.5 * (a @ b.T)
            grads.append(g * dK)
        return tuple(grads)


class GridPosterior:
    """Eigen-factors of the grid posterior (GPy: grid_posterior.py:1-62)."""

    def __init__(self, eigs, S, alpha):
        self.eigs = eigs          # [(S_d, Q_d)] per axis
        self.S = S                # kron eigenvalue grid + sigma2
        self.alpha = alpha        # (K + sigma2 I)^-1 y as a grid tensor


class GaussianGridInference:
    """Exact Gaussian inference when K = kron_d K_d over a tensor grid."""

    def inference(self, kernels, Xs_list, noise_var, Y):
        """Y is the grid tensor with shape (n_1, ..., n_D). Returns
        (GridPosterior, log marginal); the log marginal is differentiable
        with respect to noise_var and each kernel's parameters."""
        Ks = [k.K(X) for k, X in zip(kernels, Xs_list)]
        out = _GridLogMarginal.apply(Y, noise_var, *Ks)
        D = len(Ks)
        lm, S, alpha = out[0], out[1], out[2]
        Qs, Ss = out[3:3 + D], out[3 + D:]
        return GridPosterior(list(zip(Ss, Qs)), S, alpha), lm
